"""Real multi-PROCESS execution: 2 jax.distributed processes on CPU.

The reference's scale story is grid job arrays over a shared filesystem
(/root/reference/src/pipelines/canu/Execution.pm:862-937); ours is
multiple jax processes joined into one device mesh with collectives.
This launches 2 actual OS processes (4 virtual CPU devices each -> an
8-device global mesh), feeds each process ONLY its host shard of reads,
and asserts the sharded meryl (k=16 one-lane AND k=22 two-lane) and the
ring all-vs-all candidates equal the single-device implementations.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow


def test_two_process_sharded_stages(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo
    worker = os.path.join(repo, "tests", "mp_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", "29831"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=str(tmp_path),
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    assert procs[0].returncode == 0, outs[0][-3000:]
    assert procs[1].returncode == 0, outs[1][-3000:]
    assert "MP_TEST_OK" in outs[0], outs[0][-3000:]
    assert "MP_TEST_OK2" in outs[0], outs[0][-3000:]
    assert "MP_TEST_OK3" in outs[0], outs[0][-3000:]
    assert "range-exchange store" in outs[0], outs[0][-1500:]
    assert "8 global devices" in outs[0], outs[0][-1500:]


def test_two_process_full_pipeline(tmp_path):
    """The ENTIRE pipeline 2-process SPMD on one shared workdir, outputs
    equal to a single-process run on the same input (VERDICT r3 #5)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo
    worker = os.path.join(repo, "tests", "mp_pipeline_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", "29847"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=str(tmp_path),
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    assert procs[0].returncode == 0, outs[0][-4000:]
    assert procs[1].returncode == 0, outs[1][-4000:]
    assert "MP_PIPELINE_OK" in outs[0], outs[0][-4000:]

    # single-process run on the identical input (the 8 local virtual
    # devices take the same sharded code paths, process_count=1)
    from canu_tpu.config.registry import Config
    from canu_tpu.io import fastx
    from canu_tpu.pipeline.driver import run_pipeline

    cfg = Config()
    cfg.set("genomeSize", 30_000)
    sp = tmp_path / "sp_asm"
    run_pipeline(str(sp), "asm", cfg,
                 raw_reads=[str(tmp_path / "raw.fasta")])

    def contig_seqs(d):
        return sorted(
            rec.seq for rec in fastx.read_fastx(os.path.join(d, "asm.contigs.fasta"))
        )

    mp_seqs = contig_seqs(str(tmp_path / "mp_asm"))
    sp_seqs = contig_seqs(str(sp))
    assert mp_seqs == sp_seqs, (
        len(mp_seqs), len(sp_seqs),
        [len(s) for s in mp_seqs], [len(s) for s in sp_seqs],
    )
