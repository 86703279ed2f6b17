"""Myers bit-vector banded extension vs the XLA scan reference kernel.

On straight-diagonal bands the two must agree exactly; with drifting
bands the Myers kernel's soft boundary (the column entering above the
window priced as its neighbour + 1, edlib-style) may only IMPROVE on
banded_extend's hard-INF wall, never worsen it; along the band's low
edge both take the same diagonal into each row's first column.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from canu_tpu.ops.align import banded_extend
from canu_tpu.ops.myers import banded_extend_myers


def _mutate(x, rate, rng):
    out = []
    for c in x:
        r = rng.random()
        if r < rate * 0.25:
            continue
        if r < rate * 0.6:
            out.append(rng.integers(0, 4))
        elif r < rate:
            out.extend([rng.integers(0, 4), c])
        else:
            out.append(c)
    return np.array(out, np.uint8)


def _cases(seed, B, LA, band, drift=False):
    rng = np.random.default_rng(seed)
    n_rows = LA
    a = np.zeros((B, LA), np.uint8)
    b = np.zeros((B, LA + band), np.uint8)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    centers = np.zeros((B, n_rows + 1), np.int32)
    for i in range(B):
        rate = [0.0, 0.05, 0.1, 0.15][i % 4]
        src = rng.integers(0, 4, size=rng.integers(100, LA)).astype(np.uint8)
        x, y = src.copy(), _mutate(src, rate, rng)
        if i % 3 == 0:
            y = y[: max(50, len(y) - rng.integers(0, 200))]
        if i % 5 == 0:
            x = x[: max(50, len(x) - rng.integers(0, 200))]
        a[i, : len(x)] = x
        a_len[i] = len(x)
        b[i, : min(len(y), LA + band)] = y[: LA + band]
        b_len[i] = min(len(y), LA + band)
        if drift:
            step = (rng.random(n_rows) < 0.6).astype(np.int32)
            centers[i] = np.concatenate([[0], np.cumsum(step)])
        else:
            centers[i] = np.arange(n_rows + 1)
    return (
        jnp.asarray(a), jnp.asarray(a_len), jnp.asarray(b), jnp.asarray(b_len),
        jnp.asarray(centers),
    ), n_rows


@pytest.mark.slow
def test_myers_matches_reference_straight_band():
    args, n_rows = _cases(0, 16, 512, 128)
    e1, au1, bu1 = map(np.asarray, banded_extend(*args, band=128, n_rows=n_rows))
    e2, au2, bu2 = map(np.asarray, banded_extend_myers(*args, band=128, n_rows=n_rows))
    assert e1.tolist() == e2.tolist()
    assert au1.tolist() == au2.tolist()
    assert bu1.tolist() == bu2.tolist()


@pytest.mark.slow
def test_myers_never_worse_with_drifting_band():
    args, n_rows = _cases(7, 24, 512, 128, drift=True)
    e1, _, _ = map(np.asarray, banded_extend(*args, band=128, n_rows=n_rows))
    e2, au2, bu2 = map(np.asarray, banded_extend_myers(*args, band=128, n_rows=n_rows))
    # soft wall <= hard wall, and both bounded below by 0
    assert (e2 <= e1).all(), (e1.tolist(), e2.tolist())
    assert (e2 >= 0).all()
    # used extents stay within the inputs
    a_len = np.asarray(args[1])
    b_len = np.asarray(args[3])
    assert (au2 <= a_len).all() and (bu2 <= b_len).all()
    # the extension consumed at least one read completely
    assert ((au2 == a_len) | (bu2 == b_len)).all()


@pytest.mark.slow
def test_myers_zero_length_edges():
    B, LA, band = 8, 256, 128
    a = np.zeros((B, LA), np.uint8)
    b = np.zeros((B, LA + band), np.uint8)
    a_len = np.array([0, 5, 0, 100, 256, 1, 2, 0], np.int32)
    b_len = np.array([0, 0, 7, 100, 256, 1, 300, 384], np.int32)
    centers = np.broadcast_to(
        np.arange(LA + 1, dtype=np.int32)[None, :], (B, LA + 1)
    ).copy()
    args = (jnp.asarray(a), jnp.asarray(a_len), jnp.asarray(b), jnp.asarray(b_len),
            jnp.asarray(centers))
    e1, au1, bu1 = map(np.asarray, banded_extend(*args, band=band, n_rows=LA))
    e2, au2, bu2 = map(np.asarray, banded_extend_myers(*args, band=band, n_rows=LA))
    assert e1.tolist() == e2.tolist()
    assert au1.tolist() == au2.tolist()
    assert bu1.tolist() == bu2.tolist()


def _low_edge_cases(seed, B, LA, band):
    """B is A with 20-40% of its bases deleted, the band centered on the
    main diagonal: the true path falls behind the band and runs along
    its low edge, moving diagonally into each row's first column."""
    rng = np.random.default_rng(seed)
    a = np.zeros((B, LA), np.uint8)
    b = np.zeros((B, LA + band), np.uint8)
    a_len = np.full(B, LA, np.int32)
    b_len = np.zeros(B, np.int32)
    for i in range(B):
        x = rng.integers(0, 4, LA).astype(np.uint8)
        y = x[rng.random(LA) >= 0.2 + 0.1 * (i % 3)]
        a[i] = x
        b[i, : len(y)] = y
        b_len[i] = len(y)
    centers = np.broadcast_to(np.arange(LA + 1, dtype=np.int32), (B, LA + 1))
    return tuple(map(jnp.asarray, (a, a_len, b, b_len, centers.copy())))


def test_myers_follows_the_band_low_edge():
    # the first cell of a moved window takes the diagonal from the column
    # that left it, as banded_extend's does: both DPs see the same path
    args = _low_edge_cases(3, 32, 512, 128)
    r1 = [np.asarray(x) for x in banded_extend(*args, band=128, n_rows=512)]
    r2 = [np.asarray(x) for x in banded_extend_myers(*args, band=128, n_rows=512)]
    for x, y in zip(r1, r2):
        np.testing.assert_array_equal(x, y)
