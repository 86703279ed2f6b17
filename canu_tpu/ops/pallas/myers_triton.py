"""Pallas-Triton kernel for the Myers bit-vector banded extension.

Same algorithm and bit-exact results as the XLA-scan segment kernel in
canu_tpu.ops.myers (_myers_segment) — Myers 1999 block chaining, the
algorithm family of the reference's vendored edlib
(/root/reference/src/overlapInCore/libedlib/edlib.C) — with the whole
row loop inside one kernel launch:

  * ONE PAIR PER THREAD: the grid runs over blocks of BLOCK pairs only,
    and a fori_loop over the DP rows runs inside the block.  The ~43 u32
    of per-pair state (4 VP + 4 VN + 16 Peq word planes, the score and
    band tracker, the B-exhaustion / A-exhaustion / partial-endpoint
    captures) stay in registers for the whole extension;
  * each block loops only to the longest A of its own pairs (rows past
    a pair's a_len are no-ops in the DP, so the early stop is exact);
  * inputs are streamed in row order from the packed planes that
    myers._pack_inputs builds: the per-row (shift, a-char) pair is 3 bits,
    8 rows per u32; the entering B chars come from the 2-bit-packed B
    read as TWO u32 words per 16-row block (the band start advances <= 1
    column/row, so a block consumes <= 16 consecutive chars).  Every load
    is contiguous across the pairs of a block; there is no per-row
    gather;
  * Triton lowers population_count only for int32/int64, so the u32
    words are bitcast before the popcount; every shift amount is kept
    below 32 (an over-wide shift is undefined in the lowering).

Chars past a read's end only ever enter band column 128, word-chain
carries flow low->high and every capture masks columns <= b_len, so the
garbage chars the packed fetch reads there cannot change a result.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NW = 4  # uint32 word planes per 128-column band
WORD = 32
BAND = NW * WORD
INF = 1 << 28

# carry plane indices (all planes uint32-bitcast, [B] each)
_VP = 0
_VN = _VP + NW
_PEQ = _VN + NW  # 4 chars x NW words
_SF = _PEQ + 4 * NW
_O = _SF + 1
_BEST = _O + 1
_AEND = _BEST + 1
_BEND = _AEND + 1
_FVP = _BEND + 1
_FVN = _FVP + NW
_FSF = _FVN + NW
_FO = _FSF + 1
_PEXT = _FO + 1
_PED = _PEXT + 1
_PA = _PED + 1
_PB = _PA + 1
NC = _PB + 1  # 43

# pairs per program: one warp, one pair per thread.  64 pairs on 2 warps
# and 128 on 4 time the same on an H100; the row chain of each thread,
# not occupancy, bounds the kernel (PERF.md, Kernel choices)
BLOCK = 32
NUM_WARPS = 1


def _u(x):
    return x.astype(jnp.uint32)


def _i(x):
    return x.astype(jnp.int32)


def _popc(x):
    """popcount of u32 words as int32 (bitcast: Triton counts int32)."""
    return jax.lax.population_count(jax.lax.bitcast_convert_type(x, jnp.int32))


def _myers_block_kernel(capq_ref, carry0_ref, sa_ref, ew0_ref, ew1_ref,
                        bw_ref, alen_ref, blen_ref, out_ref, *, n_rows: int):
    """All rows of the Myers DP for one block of pairs.

    carry0_ref/out_ref [NC, BLOCK] u32: initial / final carry planes.
    sa_ref [n_rows/8, BLOCK] u32: rows 8r..8r+7 packed 3 bits each
      (bit0 = band shift, bits1-2 = a char).
    ew0/ew1 [n_rows/16, BLOCK] u32: 2-bit-packed B words holding the <=16
      entering chars of each 16-row block (and the next word).
    bw [n_rows/16, BLOCK] u32: B position of ew0's first char; the char
      entering at row i sits at bits 2*(o(i)+127-bw) of ew0:ew1.
    """
    cap_q = capq_ref[...]
    alen = alen_ref[...]
    blen = blen_ref[...]
    state0 = tuple(carry0_ref[c] for c in range(NC))

    u0 = jnp.uint32(0)
    u1 = jnp.uint32(1)
    u3 = jnp.uint32(3)
    u31 = jnp.uint32(31)
    ones = jnp.full(alen.shape, 0xFFFFFFFF, jnp.uint32)
    zeros = jnp.zeros(alen.shape, jnp.uint32)

    def shift_chain(X, ins):
        out = []
        for k in range(NW):
            hi = X[k + 1] if k + 1 < NW else ins
            out.append((X[k] >> u1) | (hi << u31))
        return out

    def sel(cond, a, b):
        return [jnp.where(cond, x, y) for x, y in zip(a, b)]

    def word_mask(w, k):
        # low clip(w - 32k, 0, 32) bits set; the all-bits case is
        # selected explicitly so no shift reaches 32
        m = jnp.clip(w - k * WORD, 0, WORD)
        low = (u1 << _u(m & 31)) - u1
        return jnp.where(m == WORD, ones, low)

    def masked_score(VP, VN, sf, w):
        acc = sf
        for k in range(NW):
            mask = word_mask(w, k)
            acc = acc + _popc(VP[k] & mask) - _popc(VN[k] & mask)
        return acc

    def body(i, st):
        VP = list(st[_VP:_VP + NW])
        VN = list(st[_VN:_VN + NW])
        Peq = [list(st[_PEQ + NW * c:_PEQ + NW * c + NW]) for c in range(4)]
        sf = _i(st[_SF])
        o = _i(st[_O])
        best_bx = _i(st[_BEST])
        aend_bx = _i(st[_AEND])
        bend_bx = _i(st[_BEND])
        fVP = list(st[_FVP:_FVP + NW])
        fVN = list(st[_FVN:_FVN + NW])
        fsf = _i(st[_FSF])
        fo = _i(st[_FO])
        p_ext = _i(st[_PEXT])
        p_ed = _i(st[_PED])
        p_a = _i(st[_PA])
        p_b = _i(st[_PB])

        sa = sa_ref[i >> 3] >> _u(3 * (i & 7))
        s = _i(sa & u1)
        ach = _i((sa >> u1) & u3)
        i_abs = i + 1
        live = i_abs <= alen
        s = jnp.where(live, s, 0)
        do_shift = s > 0
        o_new = o + s

        # ---- entering char: bits 2*(o_new + 127 - bw) of ew0:ew1 ----
        off2 = 2 * (o_new + (BAND - 1) - _i(bw_ref[i >> 4]))
        lo = (ew0_ref[i >> 4] >> _u(off2 & 31)) & u3
        hi = (ew1_ref[i >> 4] >> _u(jnp.maximum(off2 - 32, 0) & 31)) & u3
        bch = _i(jnp.where(off2 < 32, lo, hi))

        # ---- window shift; the new first cell keeps its diagonal from
        # the column that leaves (myers._myers_segment) ----
        eq0 = u0
        for c in range(4):
            eq0 = eq0 | jnp.where(ach == c, Peq[c][0], u0)
        dg0 = sf + _i((eq0 & u1) ^ u1)
        sf_sh = sf + _i(VP[0] & u1) - _i(VN[0] & u1)
        VP = sel(do_shift, shift_chain(VP, ones), VP)  # below-band wall: +1
        VN = sel(do_shift, shift_chain(VN, zeros), VN)
        for c in range(4):
            ins = jnp.where(bch == c, u1, u0)
            Peq[c] = sel(do_shift, shift_chain(Peq[c], ins), Peq[c])
        sf = jnp.where(do_shift, sf_sh, sf)
        o = o_new

        # ---- Myers column update (chained words) ----
        hin = jnp.where(do_shift, jnp.minimum(dg0 - sf, 1), 1)
        hp_in = jnp.where(hin > 0, u1, u0)
        hm_in = jnp.where(hin < 0, u1, u0)
        nVP, nVN = [], []
        for k in range(NW):
            Eq_all = (jnp.where(ach == 0, Peq[0][k], u0)
                      | jnp.where(ach == 1, Peq[1][k], u0)
                      | jnp.where(ach == 2, Peq[2][k], u0)
                      | jnp.where(ach == 3, Peq[3][k], u0))
            Pv, Mv = VP[k], VN[k]
            Xv = Eq_all | Mv
            Eq = Eq_all | hm_in
            Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq
            Ph = Mv | ~(Xh | Pv)
            Mh = Pv & Xh
            hp_out = Ph >> u31
            hm_out = Mh >> u31
            Ph = (Ph << u1) | hp_in
            Mh = (Mh << u1) | hm_in
            nVP.append(Mh | ~(Xv | Ph))
            nVN.append(Ph & Xv)
            hp_in, hm_in = hp_out, hm_out
        VP = sel(live, nVP, VP)
        VN = sel(live, nVN, VN)
        sf = jnp.where(live, sf + hin, sf)

        # ---- B-exhaustion capture ----
        wb = blen - o
        inw = (wb >= 0) & (wb < BAND) & live
        cost = jnp.where(inw, masked_score(VP, VN, sf, jnp.clip(wb, 0, BAND)),
                         INF)
        better = cost < best_bx
        best_bx = jnp.where(better, cost, best_bx)
        aend_bx = jnp.where(better, i_abs, aend_bx)
        bend_bx = jnp.where(better, blen, bend_bx)

        # ---- A-exhaustion capture ----
        at_fin = i_abs == alen
        fVP = sel(at_fin, VP, fVP)
        fVN = sel(at_fin, VN, fVN)
        fsf = jnp.where(at_fin, sf, fsf)
        fo = jnp.where(at_fin, o, fo)

        # ---- best in-envelope partial endpoint at the band center ----
        jc = o + BAND // 2
        sc = sf
        for kk in range(NW // 2):
            sc = sc + _popc(VP[kk]) - _popc(VN[kk])
        ext = i_abs + jc
        sc_c = jnp.minimum(sc, 80_000)
        ext_c = jnp.minimum(ext, 400_000)
        ok = (jc <= blen) & live & (sc_c * 20000 <= cap_q * ext_c) & (ext > p_ext)
        p_ext = jnp.where(ok, ext, p_ext)
        p_ed = jnp.where(ok, sc, p_ed)
        p_a = jnp.where(ok, i_abs, p_a)
        p_b = jnp.where(ok, jc, p_b)

        return (tuple(VP) + tuple(VN)
                + tuple(Peq[0]) + tuple(Peq[1]) + tuple(Peq[2]) + tuple(Peq[3])
                + (_u(sf), _u(o), _u(best_bx), _u(aend_bx), _u(bend_bx))
                + tuple(fVP) + tuple(fVN)
                + (_u(fsf), _u(fo), _u(p_ext), _u(p_ed), _u(p_a), _u(p_b)))

    # rows past every pair's a_len change nothing: stop at the block's
    # longest A (the blocks of a length-sorted batch end at different rows)
    n_live = jnp.minimum(jnp.max(alen), n_rows)
    state = jax.lax.fori_loop(0, n_live, body, state0)
    for c in range(NC):
        out_ref[c] = state[c]


@partial(jax.jit, static_argnames=("interpret",))
def myers_run_triton(carry0, sa, ew0, ew1, bw, alen, blen, cap_q, *,
                     interpret: bool = False):
    """Run every Myers row for all pairs in one kernel launch.

    carry0: [NC, B] u32 initial carry planes (B a multiple of BLOCK).
    sa: [n_rows/8, B] u32 (8 rows x 3 bits: shift | a_chr<<1).
    ew0/ew1/bw: [n_rows/16, B] u32 per-16-row-block entering-B words and
    their base position.  alen/blen: [B] i32.  cap_q: i32 scalar
    (partial-overlap erate envelope in 0.01% units).  Returns the final
    carry [NC, B] u32.
    """
    B = carry0.shape[1]
    assert B % BLOCK == 0, f"pairs {B} not a multiple of {BLOCK}"
    n_rows = sa.shape[0] * 8
    assert ew0.shape[0] * 16 == n_rows
    capq = jnp.full((BLOCK,), cap_q, jnp.int32)
    kernel = partial(_myers_block_kernel, n_rows=n_rows)

    def rows(n):
        return pl.BlockSpec((n, BLOCK), lambda j: (0, j))

    lane = pl.BlockSpec((BLOCK,), lambda j: (j,))
    return pl.pallas_call(
        kernel,
        grid=(B // BLOCK,),
        in_specs=[
            pl.BlockSpec((BLOCK,), lambda j: (0,)),
            rows(NC), rows(sa.shape[0]),
            rows(ew0.shape[0]), rows(ew0.shape[0]), rows(ew0.shape[0]),
            lane, lane,
        ],
        out_specs=rows(NC),
        out_shape=jax.ShapeDtypeStruct((NC, B), jnp.uint32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="myers_extend",
    )(capq, carry0, sa, ew0, ew1, bw, alen, blen)
