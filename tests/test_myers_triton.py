"""Triton Myers kernel vs the XLA-scan reference: bit-identical results.

Runs the Pallas-Triton kernel in interpret mode on CPU (small shapes —
the interpreter executes every ref op individually) and compares every
output against the XLA implementation, including partial-overlap
endpoints.  chip_smoke.py runs the same comparison compiled on the GPU
at full width.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest

from canu_tpu.ops.myers import banded_extend_myers
from canu_tpu.ops.pallas.myers_triton import BLOCK


def _mutate(rng, seq, er):
    out = []
    for c in seq:
        r = rng.random()
        if r < er * 0.4:
            continue
        elif r < er * 0.7:
            out += [int(c), int(rng.integers(0, 4))]
        elif r < er:
            out.append(int((c + 1 + rng.integers(0, 3)) % 4))
        else:
            out.append(int(c))
    return np.array(out, np.uint8)


@pytest.mark.parametrize("partial_cap_q", [None, 1500])
@pytest.mark.parametrize("er", [0.05, 0.2])
def test_triton_matches_xla(er, partial_cap_q):
    rng = np.random.default_rng(int(er * 100))
    # not a multiple of BLOCK: the wrapper pads and strips the batch;
    # staggered A lengths end the kernel's per-block loops at different rows
    B, LA, LB, n_rows = BLOCK + 5, 150, 160, 128
    A = np.zeros((B, n_rows), np.uint8)
    Bb = np.zeros((B, LB + 128), np.uint8)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    for i in range(B):
        base = rng.integers(0, 4, LA).astype(np.uint8)
        mb = _mutate(rng, base, er)[:LB]
        a_len[i] = min(LA, n_rows) - (i % 7) * 9
        b_len[i] = len(mb)
        A[i, : a_len[i]] = base[: a_len[i]]
        Bb[i, : len(mb)] = mb
    # degenerate rows: empty A, empty B
    a_len[B - 1] = 0
    b_len[B - 2] = 0
    centers = np.arange(n_rows + 1, dtype=np.int32)[None, :].repeat(B, 0)

    args = (
        jnp.asarray(A), jnp.asarray(a_len), jnp.asarray(Bb),
        jnp.asarray(b_len), jnp.asarray(centers),
    )
    r_xla = banded_extend_myers(*args, 128, n_rows,
                                partial_cap_q=partial_cap_q, impl="xla")
    r_tri = banded_extend_myers(*args, 128, n_rows,
                                partial_cap_q=partial_cap_q,
                                impl="triton_interpret")
    assert len(r_xla) == len(r_tri) == (3 if partial_cap_q is None else 6)
    names = ("edits", "a_used", "b_used", "p_edits", "p_a", "p_b")
    for name, x, p in zip(names, r_xla, r_tri):
        np.testing.assert_array_equal(
            np.asarray(x), np.asarray(p), err_msg=f"{name} mismatch"
        )


@pytest.mark.parametrize("partial_cap_q", [None, 1500])
def test_triton_matches_xla_low_edge(partial_cap_q):
    # B is A with a third of its bases deleted and the band on the main
    # diagonal, so the path hugs the band's low edge and the moved
    # window's first cell takes every boundary delta (-1, 0, +1)
    rng = np.random.default_rng(9)
    B, LA, n_rows = BLOCK, 256, 256
    A = rng.integers(0, 4, (B, LA)).astype(np.uint8)
    Bb = np.zeros((B, LA + 128), np.uint8)
    b_len = np.zeros(B, np.int32)
    for i in range(B):
        y = A[i][rng.random(LA) >= 0.33]
        Bb[i, : len(y)] = y
        b_len[i] = len(y)
    a_len = np.full(B, LA, np.int32) - np.arange(B, dtype=np.int32)
    centers = np.arange(n_rows + 1, dtype=np.int32)[None, :].repeat(B, 0)
    args = tuple(map(jnp.asarray, (A, a_len, Bb, b_len, centers)))
    r_xla = banded_extend_myers(*args, 128, n_rows,
                                partial_cap_q=partial_cap_q, impl="xla")
    r_tri = banded_extend_myers(*args, 128, n_rows,
                                partial_cap_q=partial_cap_q,
                                impl="triton_interpret")
    for x, p in zip(r_xla, r_tri):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(p))
