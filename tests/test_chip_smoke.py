"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phase functions hold at toy size (Triton kernel in interpret mode)."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from canu_tpu.ops.pallas.myers_triton import BLOCK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [[], ["--multichip"]])
def test_main_refuses_cpu(argv, capsys):
    with pytest.raises(SystemExit) as ei:
        cs.main(argv)
    assert ei.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture(scope="module")
def toy_reads():
    return cs.bench_readset(genome=30_000, coverage=6)


def test_myers_phase_toy(toy_reads):
    rs, _ = toy_reads
    ext_in, n_rows, max_rows = cs.verify_group_inputs(rs, chunk=16,
                                                      n_chunks=2)
    assert ext_in[0].shape == (64, n_rows)
    cs.check_myers_engines(ext_in, n_rows, max_rows, "triton_interpret")


def test_myers_vs_banded_phase_toy(toy_reads):
    rs, _ = toy_reads
    ext_in, n_rows, _ = cs.verify_group_inputs(rs, chunk=8, n_chunks=1)
    cs.check_myers_vs_banded(ext_in, n_rows, "xla", "real", exact=False)


@pytest.mark.parametrize("drift", [False, True])
def test_myers_vs_banded_synthetic_toy(drift):
    ext_in = cs.synthetic_extensions(16, 512, seed=3, drift=drift)
    assert ext_in[0].shape == (16, 512) and ext_in[2].shape == (16, 640)
    assert ext_in[4].shape == (16, 513)
    steps = np.diff(np.asarray(ext_in[4]), axis=1)
    assert set(np.unique(steps)) <= ({0, 1} if drift else {1})
    cs.check_myers_vs_banded(ext_in, 512, "xla", "toy", exact=not drift)


def test_myers_drift_engines_toy():
    ext_in = cs.synthetic_extensions(BLOCK, 256, seed=4, drift=True)
    cs.check_myers_engines(ext_in, 256, 256, "triton_interpret", ".drift")


def test_vote_block_phase_toy(toy_reads):
    rs, truth = toy_reads
    cpu = jax.devices("cpu")[0]
    cs.check_vote_block(rs, truth, cpu, cpu, max_len=1000, n_jobs=32)


def test_kmer_phase_toy(toy_reads):
    rs, _ = toy_reads
    cs.check_kmers(rs)


def test_failed_check_raises():
    with pytest.raises(cs.SmokeFailure):
        cs.check("toy", False, "detail", "tolerance")


def test_stage_walls_sums_attempts(tmp_path):
    p = tmp_path / "t.jsonl"
    p.write_text('{"stage": "a", "wall_s": 1.5}\n{"stage": "a", "wall_s": 2.0}\n'
                 '{"stage": "b", "wall_s": 3.0}\n{"stage": "b", "sub": 1}\n')
    assert cs.stage_walls(str(p)) == {"a": 3.5, "b": 3.0}
