"""Assembly pipeline driver (canu.pl executive equivalent).

Replaces the reference Perl executive's phase sequencing
(/root/reference/src/pipelines/canu.pl:653-764: correction -> trimming ->
assembly, each re-running gatekeeper/meryl/overlap first) and its
resume/retry contract (/root/reference/src/pipelines/canu/Execution.pm):

  * every stage is idempotent; done-ness = existence of its output files
    ("goto allDone if fileExists(...)", OverlapMhap.pm:82-85);
  * stages retry up to canuIterationMax times (Execution.pm:1061-1098);
  * `stopAfter=<stage>` halts at named points (Defaults.pm:1322-1334);
  * all stage begin/end times are logged to canu-logs/ (AS_global.C:130).

No grid: stages run in-process; heavy compute is on the accelerator.
Multi-host distribution shards *within* device ops (canu_tpu.parallel),
not by scattering processes.
"""

from __future__ import annotations

import json
import logging
import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..config import Config, ConfigError
from .report import Report


class PipelineError(RuntimeError):
    pass


class StopPipeline(Exception):
    """Raised to honor stopAfter."""


@dataclass
class AssemblyCtx:
    work_dir: str
    prefix: str
    cfg: Config
    report: Report = None  # type: ignore[assignment]
    log: logging.Logger = None  # type: ignore[assignment]

    def path(self, *parts: str) -> str:
        return os.path.join(self.work_dir, *parts)

    def phase_dir(self, phase: str) -> str:
        d = self.path(phase)
        os.makedirs(d, exist_ok=True)
        return d


def make_ctx(work_dir: str, prefix: str, cfg: Config) -> AssemblyCtx:
    os.makedirs(work_dir, exist_ok=True)
    logs = os.path.join(work_dir, "canu-logs")
    os.makedirs(logs, exist_ok=True)
    # AS_global-equivalent process init: invocation audit + crash catcher
    from ..utils.runtime import audit_invocation, install_crash_catcher

    audit_invocation(logs, "canu_tpu")
    install_crash_catcher(logs)
    logger = logging.getLogger(f"canu_tpu.{prefix}")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        fh = logging.FileHandler(os.path.join(logs, f"{int(time.time())}_{os.getpid()}.log"))
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("-- %(message)s"))
        logger.addHandler(sh)
    ctx = AssemblyCtx(work_dir, prefix, cfg)
    ctx.report = Report(os.path.join(work_dir, f"{prefix}.report"))
    ctx.log = logger
    return ctx


def run_stage(ctx: AssemblyCtx, name: str, done: Callable[[], bool], fn: Callable[[], None],
              collective: bool = False) -> None:
    """Idempotent stage execution with bounded retries + stopBefore/stopAfter.

    Multi-process (jax.process_count() > 1) coordination: a barrier
    before the done() check makes file-existence resume coherent across
    processes (no process consults done() until every process has passed
    the previous stage's writes), and a barrier after fn() holds readers
    until the writer's outputs are renamed.  ``collective=True`` marks a
    stage whose fn contains cross-process collectives — EVERY process
    must enter fn in lockstep; non-collective stages run fn on the
    writer (process 0) only.  Distributed stages get a single attempt:
    an in-process retry on one process would desynchronize the
    collective schedule (the reference recovers by relaunching the whole
    executive, Execution.pm:610-712 — ours is scripts/scale_run.py's
    relaunch loop)."""
    from ..parallel.launch import barrier, is_distributed, is_writer

    dist = is_distributed()
    if dist:
        barrier(f"pre-{name}")
    if ctx.cfg.get("stopBefore").lower() == name.lower() and not done():
        ctx.log.info(f"stopBefore={name}: halting")
        raise StopPipeline(name)
    if bool(ctx.cfg.get("showNext")) and not done():
        # reference showNext: report the next step, change nothing
        ctx.log.info(f"showNext: next stage is '{name}'")
        print(f"next stage: {name}", flush=True)
        raise StopPipeline(name)
    if done():
        ctx.log.info(f"{name}: already done, skipping")
    elif dist:
        t0 = time.time()
        ctx.log.info(f"{name}: start (distributed, "
                     f"{'collective' if collective else 'writer-only'})")
        if collective or is_writer():
            fn()
        barrier(f"fn-{name}")
        if not done():
            raise PipelineError(f"{name}: ran but outputs missing")
        ctx.log.info(f"{name}: done in {time.time()-t0:.1f}s")
    else:
        max_iter = int(ctx.cfg.get("canuIterationMax"))
        for attempt in range(1, max_iter + 1):
            t0 = time.time()
            ctx.log.info(f"{name}: start (attempt {attempt}/{max_iter})")
            try:
                fn()
                if not done():
                    raise PipelineError(f"{name}: ran but outputs missing")
                wall = time.time() - t0
                ctx.log.info(f"{name}: done in {wall:.1f}s")
                # persistent per-stage wall breakdown (the reference logs
                # wall+disk per command, Execution.pm:1362-1384); one
                # JSONL line per completed stage attempt
                try:
                    with open(ctx.path(f"{ctx.prefix}.stage-times.jsonl"), "a") as fh:
                        json.dump({"stage": name, "wall_s": round(wall, 1),
                                   "attempt": attempt,
                                   "t_end": round(time.time(), 1)}, fh)
                        fh.write("\n")
                except OSError:
                    pass
                break
            except (StopPipeline, KeyboardInterrupt):
                raise
            except Exception as e:
                ctx.log.error(f"{name}: attempt {attempt} failed: {e}\n{traceback.format_exc()}")
                if attempt == max_iter:
                    raise PipelineError(f"{name} failed after {max_iter} attempts") from e
                # recover between attempts instead of replaying into the
                # same wall: an E. coli attempt 2 re-OOMed 4 ms after
                # attempt 1 because the device still held every buffer.
                # Free them and shrink the verify window before
                # re-entering fn().
                from ..utils import runtime as RT

                if RT.is_oom_error(e):
                    n_freed = RT.recover_device_memory()
                    from ..ops.align import _INFLIGHT_BACKOFF

                    ctx.log.info(
                        f"{name}: OOM recovery freed {n_freed} device "
                        f"arrays; verify in-flight budget x{_INFLIGHT_BACKOFF:g}"
                    )
                    time.sleep(5.0)
    if dist:
        barrier(f"post-{name}")
    if ctx.cfg.get("stopAfter").lower() == name.lower():
        ctx.log.info(f"stopAfter={name}: halting")
        raise StopPipeline(name)


# ---- pipeline --------------------------------------------------------------


def run_pipeline(
    work_dir: str,
    prefix: str,
    cfg: Config,
    raw_reads: Optional[list[str]] = None,
    corrected_reads: Optional[list[str]] = None,
    trimmed_reads: Optional[list[str]] = None,
) -> AssemblyCtx:
    """Full hierarchical pipeline: correct -> trim -> assemble.

    Entry points match the reference's -pacbio-raw / -pacbio-corrected /
    -trimmed distinctions (canu.pl mode detection, canu.pl:341-525).
    """
    from . import stages

    cfg.apply_read_type_profile()
    cfg.validate()
    ctx = make_ctx(work_dir, prefix, cfg)
    from ..parallel.launch import is_writer

    if is_writer():
        with open(ctx.path(f"{prefix}.spec.used"), "w") as fh:
            json.dump(cfg.to_dict(), fh, indent=1, default=str)
    # resource solver (Configure.pm role): maxMemory/maxThreads + the
    # device's HBM size set spill thresholds, sort budgets and the vote
    # engine's chunk geometry
    from .configure import configure_resources

    configure_resources(cfg, ctx.log)

    if bool(cfg.get("useGrid")):
        # join the multi-host jax cluster (Grid_*.pm role): afterwards
        # jax.device_count() spans hosts, so shardedCompute=auto runs the
        # meryl/overlap stages over the full mesh
        from ..parallel.launch import init_distributed

        pi, n = init_distributed()
        import jax

        ctx.log.info(
            "useGrid: process %d/%d joined, %d global devices",
            pi, n, jax.device_count(),
        )

    obstore = None
    spec = str(cfg.get("objectStore")).strip()
    if spec:
        from .objectstore import make_object_store

        obstore = make_object_store(spec)

    def _stage_outputs() -> list[tuple[str, str]]:
        # (local path, object key) pairs of the durable phase outputs
        outs = [
            ("correction/" + f"{prefix}.correctedReads.fasta.gz",) * 2,
            ("trimming/" + f"{prefix}.trimmedReads.fasta.gz",) * 2,
            (f"{prefix}.contigs.fasta",) * 2,
            (f"{prefix}.unitigs.fasta",) * 2,
            (f"{prefix}.report",) * 2,
        ]
        return [(ctx.path(p), f"{prefix}/{k}") for p, k in outs]

    if obstore is not None:
        # fetch completed outputs first: a fresh machine resumes from the
        # bucket exactly like Grid_Cloud fetches stores before a stage
        for local, key in _stage_outputs():
            if not os.path.exists(local) and obstore.exists(key):
                os.makedirs(os.path.dirname(local), exist_ok=True)
                obstore.fetch_file(key, local)
                ctx.log.info("objectStore: fetched %s", key)

    def _hook(name: str) -> None:
        # onSuccess/onFailure user hooks (Defaults.pm:764-765)
        cmd = str(cfg.get(name)).strip()
        if cmd:
            import subprocess

            subprocess.run([cmd, prefix], cwd=work_dir, check=False)

    _stashed: set[str] = set()

    def _stash_ready() -> None:
        # stash every durable output that exists NOW, so a fresh machine
        # can resume mid-pipeline from the bucket (the reference's
        # Grid_Cloud stashes per-stage, not only at the end)
        if obstore is None:
            return
        for local, key in _stage_outputs():
            if key not in _stashed and os.path.exists(local):
                obstore.stash_file(local, key)
                _stashed.add(key)
                ctx.log.info("objectStore: stashed %s", key)

    try:
        if raw_reads is not None:
            stages.correction_phase(ctx, raw_reads)
            corrected_reads = [ctx.path("correction", f"{ctx.prefix}.correctedReads.fasta.gz")]
            _stash_ready()
        if corrected_reads is not None:
            stages.trimming_phase(ctx, corrected_reads)
            trimmed_reads = [ctx.path("trimming", f"{ctx.prefix}.trimmedReads.fasta.gz")]
            _stash_ready()
        if trimmed_reads is None:
            raise ConfigError("no input reads given")
        stages.assembly_phase(ctx, trimmed_reads)
    except StopPipeline:
        _stash_ready()
    except Exception:
        _stash_ready()
        _hook("onFailure")
        raise
    _stash_ready()
    from ..utils.runtime import rusage

    ru = rusage()
    ctx.log.info(
        f"pipeline finished: cpu {ru['utime_s']:.1f}s user / "
        f"{ru['stime_s']:.1f}s sys, peak rss {ru['max_rss_mb']:.0f} MB"
    )
    _hook("onSuccess")
    return ctx
