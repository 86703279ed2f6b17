"""Bacterial-scale end-to-end run through the pipeline CLI.

Simulates a 1 Mb genome at 20x (PacBio-like 10% error, read profile
matched to bench.py so warm compile-cache buckets are reused), runs the
FULL pipeline (correct -> trim -> assemble), times each phase, and
judges the assembly against the truth genome with the bogus harness.

Usage: python scripts/scale_run.py [genome_size] [coverage] [workdir]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    gsize = int(float(sys.argv[1])) if len(sys.argv) > 1 else 1_000_000
    cov = float(sys.argv[2]) if len(sys.argv) > 2 else 20.0
    wd = sys.argv[3] if len(sys.argv) > 3 else "_scale/run1m"

    from canu_tpu.io import fastx
    from canu_tpu.sim.bogus import evaluate_assembly
    from canu_tpu.sim.simulate import random_genome, simulate_reads
    from canu_tpu.utils import bitpack

    os.makedirs(wd, exist_ok=True)
    t0 = time.time()
    # CANU_TPU_REPEAT_SPEC="6000x12,2000x25" plants exact repeat families
    # (config-4 yeast-like repeat separation; sim/simulate.py repeat_spec)
    rep_env = os.environ.get("CANU_TPU_REPEAT_SPEC", "")
    repeat_spec = None
    if rep_env:
        repeat_spec = [
            (int(p.split("x")[0]), int(p.split("x")[1]))
            for p in rep_env.split(",") if p.strip()
        ]
    g = random_genome(gsize, seed=7, repeat_spec=repeat_spec)
    # CANU_TPU_SIM_ERR / CANU_TPU_READTYPE: BASELINE config 1 is a
    # lambda-phage-scale ONT profile (higher error, nanopore defaults)
    err = float(os.environ.get("CANU_TPU_SIM_ERR", "0.10"))
    read_type = os.environ.get("CANU_TPU_READTYPE", "pacbio")
    rs, _ = simulate_reads(
        g, coverage=cov, mean_len=3500, min_len=1500, max_len=7800,
        error_rate=err, seed=8,
    )
    raw_fa = os.path.join(wd, "raw.fasta")
    fastx.write_fasta(
        raw_fa,
        ((f"read{i+1}", rs.get_seq(i + 1)) for i in range(rs.n_reads)),
    )
    print(
        f"# sim: {rs.n_reads} reads, {rs.total_bases} bases "
        f"({time.time()-t0:.1f}s)", flush=True,
    )

    # Executive loop: run the pipeline CLI as a subprocess with a
    # per-attempt timeout and relaunch on failure/wedge — the reference's
    # grid-chain recovery (Execution.pm:610-712 self-resubmission): the
    # file-existence resume contract plus per-block correction outputs
    # make each relaunch continue where the last attempt stopped, and the
    # per-attempt timeout bounds the damage of a hung attempt.
    import subprocess

    # 3600 default (r5): 1500 chopped the healthy warm 4.6 Mb run TWICE
    # mid-OEA (the stage runs ~1000 s with no output in between) and the
    # aborted work + restart overhead cost ~1030 s of wall
    attempt_timeout = int(os.environ.get("CANU_TPU_ATTEMPT_TIMEOUT", "3600"))
    max_attempts = int(os.environ.get("CANU_TPU_MAX_ATTEMPTS", "8"))
    t1 = time.time()
    rc = -1
    for attempt in range(1, max_attempts + 1):
        cmd = [
            sys.executable, "-m", "canu_tpu", "-p", "asm", "-d", wd,
            f"genomeSize={gsize}", f"readType={read_type}",
            "-pacbio-raw" if read_type == "pacbio" else "-nanopore-raw",
            raw_fa,
        ]
        print(f"# attempt {attempt}/{max_attempts}", flush=True)
        try:
            r = subprocess.run(cmd, timeout=attempt_timeout,
                               cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            rc = r.returncode
        except subprocess.TimeoutExpired:
            print(f"# attempt {attempt} timed out after {attempt_timeout}s "
                  f"— relaunching with resume", flush=True)
            rc = -9
        if rc == 0:
            break
        print(f"# attempt {attempt} exited rc={rc} — relaunching", flush=True)
    if rc != 0:
        print(f"# pipeline FAILED after {max_attempts} attempts", flush=True)
        sys.exit(1)
    wall = time.time() - t1
    print(f"# pipeline wall {wall:.1f}s", flush=True)

    contigs = list(fastx.read_fastx(os.path.join(wd, "asm.contigs.fasta")))
    res = {
        "genome": gsize, "coverage": cov, "reads": rs.n_reads,
        "bases": rs.total_bases, "wall_s": round(wall, 1),
        "n_contigs": len(contigs),
    }
    # judge on CPU in a subprocess: the parent holds no device, and the
    # judge cannot fail for want of device memory after an otherwise
    # successful assembly
    ev_code = (
        "import os,sys,json\n"
        "os.environ['JAX_PLATFORMS']='cpu'\n"
        "os.environ['CANU_TPU_NO_COMPILE_CACHE']='1'\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})\n"
        "from canu_tpu.io import fastx\n"
        "from canu_tpu.sim.bogus import evaluate_assembly\n"
        "from canu_tpu.sim.simulate import random_genome\n"
        "from canu_tpu.utils import bitpack\n"
        f"g = random_genome({gsize}, seed=7, repeat_spec={repeat_spec!r})\n"
        f"cs = [bitpack.seq_to_codes(c.seq) for c in fastx.read_fastx({os.path.join(wd, 'asm.contigs.fasta')!r})]\n"
        "ev = evaluate_assembly(g, cs, k=21, circular=True)\n"
        "print(json.dumps({'ng50': ev.contig_ng50, 'ideal_ng50': ev.ideal_ng50,\n"
        "  'genome_fraction': round(ev.genome_fraction, 4),\n"
        "  'misjoins': ev.n_misjoins, 'identity': round(ev.identity, 5),\n"
        "  'summary': ev.summary()}))\n"
    )
    try:
        r = subprocess.run([sys.executable, "-c", ev_code], timeout=1800,
                           capture_output=True, text=True)
        evd = json.loads(r.stdout.strip().splitlines()[-1])
        print("# " + evd.pop("summary"), flush=True)
        res.update(evd)
    except Exception as e:  # the assembly is DONE; don't lose the result
        print(f"# evaluation failed ({e}); rerun evaluate_assembly on CPU",
              flush=True)
        res["eval_error"] = str(e)[:200]
    # per-stage wall breakdown (driver.run_stage appends one line per
    # completed stage attempt — Execution.pm:1362-1384 role)
    st_path = os.path.join(wd, "asm.stage-times.jsonl")
    if os.path.exists(st_path):
        stages = {}
        with open(st_path) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "wall_s" not in rec:
                    continue  # sub-stage profile lines carry no wall_s
                stages[rec["stage"]] = stages.get(rec["stage"], 0.0) + rec["wall_s"]
        res["stage_walls_s"] = {k: round(v, 1) for k, v in stages.items()}
    with open(os.path.join(wd, "result.json"), "w") as fh:
        json.dump(res, fh)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
