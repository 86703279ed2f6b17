"""Verify-engine choice: Myers for band 128 (Triton kernel on a GPU, XLA
scan elsewhere), the plain banded DP for any other band; no environment
variable takes part in the choice."""

import inspect

import numpy as np
import pytest

from canu_tpu.ops import align as AL
from canu_tpu.ops import myers as M
from canu_tpu.sim.simulate import random_genome, simulate_reads


def test_default_impl_is_xla_scan_off_gpu():
    assert M.default_impl() == "xla"
    # the choice follows the backend alone: no environment knob
    assert "environ" not in inspect.getsource(M)
    assert "environ" not in inspect.getsource(AL.select_engine)


@pytest.mark.parametrize("band,engine", [(128, "myers"), (192, "xla"),
                                         (256, "xla")])
def test_select_engine_by_band(band, engine):
    assert AL.select_engine("myers", band) == engine
    assert AL.select_engine("xla", band) == "xla"


@pytest.mark.parametrize("band,myers_calls", [(128, True), (192, False)])
def test_verify_overlaps_runs_selected_engine(monkeypatch, band, myers_calls):
    g = random_genome(12_000, seed=21)
    rs, _ = simulate_reads(g, coverage=4, mean_len=1500, min_len=900,
                           max_len=2000, error_rate=0.03, seed=22,
                           circular=False)
    pairs = np.array([[1, 2], [2, 3], [1, 3]], np.int64)
    calls = {"myers": 0, "banded": 0}
    real_myers, real_banded = M.banded_extend_myers, AL.banded_extend

    def spy_myers(*a, **k):
        calls["myers"] += 1
        return real_myers(*a, **k)

    def spy_banded(*a, **k):
        calls["banded"] += 1
        return real_banded(*a, **k)

    monkeypatch.setattr(M, "banded_extend_myers", spy_myers)
    monkeypatch.setattr(AL, "banded_extend", spy_banded)
    AL.verify_overlaps(rs, pairs, band=band, min_overlap=300, chunk=8,
                       min_shared=1)
    assert (calls["myers"] > 0) == myers_calls
    assert (calls["banded"] > 0) == (not myers_calls)
