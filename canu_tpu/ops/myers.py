"""Myers bit-vector banded extension — the speed-of-light verify kernel.

Replaces the per-row select/roll DP of ops.align.banded_extend with
Myers' bit-parallel algorithm (Myers 1999, the same algorithm family as
the reference's vendored edlib,
/root/reference/src/overlapInCore/libedlib/edlib.C), re-shaped for
batched elementwise hardware:

  * ONE PAIR PER LANE: every quantity is a plain elementwise uint32 op
    on a [B]-wide batch, with zero cross-lane traffic (no rolls, no
    per-row selects across pairs, no gathers in the DP update);
  * the 128-column band is 4 uint32 WORD PLANES, each its own [B] array;
    words chain exactly like edlib's blocks: only a +/-1 horizontal
    delta (hin/hout) crosses a word boundary, so the 128-bit add never
    materializes;
  * 128 DP cells update in ~60 bit-ops per word chain — ~0.5 vector op
    per DP cell-row versus ~1+ op per cell for the select/roll kernel,
    on [B]-wide vectors;
  * the band follows the anchor chain like banded_extend, but with a
    slope clamp of 1 column/row (a shift is then a single conditional
    word-chain >>1 with a per-lane bit insert — again elementwise);
  * scores are never materialized: the window-top score rides along as
    an integer (score_first), any in-window column value is
    score_first + popcount-prefix of the VP/VN planes, and the final
    A-exhausted row is unpacked once, outside the loop.

Semantics match banded_extend (extension from (0,0) until either read
is exhausted, returning (edits, a_used, b_used)).  The window holds the
129 columns o..o+128, one more than banded_extend's o..o+127.  Its first
cell D(i, o) takes D(i-1, o) + 1 or, on a row where the window moved,
the diagonal from the column that left, exactly as banded_extend
computes it; the column that enters above the window takes its
neighbour + 1 (edlib's banded boundary) instead of banded_extend's hard
INF.  Every value outside the band is thus the cost of a real path, so
under the same band schedule (any target of slope <= 1 column/row, where
the two schedules coincide) Myers' edits are never above
banded_extend's, and equal whenever the optimal path stays off the band
edges.

Two implementations of the row loop give bit-identical results: a
host-segmented lax.scan (the CPU path and the reference) and one
Pallas-Triton kernel launch per batch (pallas.myers_triton, the GPU
path).  default_impl() picks by the default backend.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

INF = 1 << 28
WORD = 32
NW = 4  # words per band: band == 128


def _band_schedule(centers: jax.Array, b_len: jax.Array, band: int) -> jax.Array:
    """Band start o(i) per row: centered on the anchor chain, clamped to
    [0, b_len], monotonic, slope <= 1 column/row (so a window shift is a
    1-bit operation).

    The slope cap makes exact tracking impossible when the target rises
    faster than 1/row (interp staircases; net-insertion drift in B).  A
    one-sided prefix-min (the old schedule) LATCHES low: after any early
    dip the band rises at exactly slope 1 and can never catch a
    net-rising center again — measured on an 80 kb contig-vs-genome
    alignment, the path left the band top and inflated the edit count
    30x.  Instead take the midpoint of the two extreme 1-Lipschitz
    monotone envelopes of the target — the forward (catch-up-from-below)
    lower envelope and the backward (anticipate-rises) upper envelope —
    which tracks the target within HALF its worst drift defect, the
    optimum for any slope-limited schedule.  For targets that are
    already slope <= 1 (straight diagonals) both envelopes equal the
    target and the schedule is unchanged."""
    t = jnp.clip(centers - band // 2, 0, jnp.maximum(b_len, 0)[:, None])
    t = jax.lax.associative_scan(jnp.maximum, t, axis=1)  # monotone target
    ramp = jnp.arange(t.shape[1], dtype=jnp.int32)[None, :]
    # forward lower envelope: min_{j<=i}(t_j - j) + i
    lo = jax.lax.associative_scan(jnp.minimum, t - ramp, axis=1) + ramp
    # backward upper envelope: max_{j>=i}(t_j - j) + i
    hi = (
        jnp.flip(
            jax.lax.associative_scan(jnp.maximum, jnp.flip(t - ramp, axis=1), axis=1),
            axis=1,
        )
        + ramp
    )
    o = (lo + hi) >> 1
    # anchor the start: the DP origin sits at column o(0), so o(0) must
    # stay at the (clipped) target start, catching up at slope 1
    return jnp.minimum(o, t[:, :1] + ramp)


def _pack_bits(bits: jax.Array) -> tuple[jax.Array, ...]:
    """bool[B, NW*32] -> NW uint32[B] word planes (bit u of word k =
    bits[:, 32k+u])."""
    B = bits.shape[0]
    b3 = bits.reshape(B, NW, WORD).astype(jnp.uint32)
    sh = jnp.arange(WORD, dtype=jnp.uint32)[None, None, :]
    words = jnp.sum(b3 << sh, axis=2, dtype=jnp.uint32)  # [B, NW] (host-prep only)
    return tuple(words[:, k] for k in range(NW))


def _unpack_bits(words: tuple[jax.Array, ...]) -> jax.Array:
    """NW uint32[B] planes -> int32[B, NW*32]."""
    sh = jnp.arange(WORD, dtype=jnp.uint32)[None, :]
    cols = [((w[:, None] >> sh) & jnp.uint32(1)).astype(jnp.int32) for w in words]
    return jnp.concatenate(cols, axis=1)


def _word_mask(w: jax.Array, k: int) -> jax.Array:
    """uint32[B]: low clip(w - 32k, 0, 32) bits set (w in [0, 128])."""
    m = jnp.clip(w - k * WORD, 0, WORD).astype(jnp.uint32)
    # (1 << 32) wraps to 0 in XLA, and 0 - 1 underflows to all-ones: exact
    return (jnp.uint32(1) << m) - jnp.uint32(1)


def _masked_score(VP, VN, sf, w):
    """D(window offset w) = score_first + popcount-prefix over w bits."""
    acc = sf
    for k in range(NW):
        mask = _word_mask(w, k)
        acc = acc + jax.lax.population_count(VP[k] & mask).astype(jnp.int32)
        acc = acc - jax.lax.population_count(VN[k] & mask).astype(jnp.int32)
    return acc


def _shift_chain(X, ins):
    """Word-chain >>1 (window moves down one column); `ins` enters bit 127."""
    out = []
    for k in range(NW):
        hi = X[k + 1] if k + 1 < NW else ins.astype(jnp.uint32)
        out.append((X[k] >> jnp.uint32(1)) | (hi << jnp.uint32(31)))
    return tuple(out)


def _sel(cond, a, b):
    """Elementwise select over word tuples."""
    return tuple(jnp.where(cond, x, y) for x, y in zip(a, b))


def _eq_bit0(Peq, ach):
    """uint32[B]: 1 where the window's first B char (Peq bit 0) equals
    the row's A char."""
    bit = jnp.uint32(0)
    for c in range(4):
        bit = bit | jnp.where(ach == c, Peq[c][0], jnp.uint32(0))
    return bit & jnp.uint32(1)


UNROLL = 8  # scan rows per loop iteration (not measured on the H100)

SEGMENT = 512  # rows per compiled segment: ONE kernel shape (B, SEGMENT)
# is reused for every segment of every chunk of every dataset, so the
# scan-length-sensitive compile happens once per batch width.


@partial(jax.jit, static_argnames=("band", "n_seg", "seg"))
def _myers_prep(b_len, centers, band: int, n_seg: int, seg: int):
    """Band schedule -> per-step shift stream + entering-char indices,
    segment-major [n_seg, seg, B].  No gathers here (they live in the
    fixed-shape segment kernel) so this program stays trivially small."""
    n_rows = n_seg * seg
    pad = n_rows + 1 - centers.shape[1]
    if pad > 0:
        centers = jnp.pad(centers, ((0, 0), (0, pad)), mode="edge")
    o_all = _band_schedule(centers.astype(jnp.int32), b_len, band)
    s_step = (o_all[:, 1 : n_rows + 1] - o_all[:, :n_rows]).astype(jnp.uint8).T
    ent_idx = (o_all[:, 1 : n_rows + 1] + (band - 1)).T  # [n_rows, B]
    B = s_step.shape[1]
    return (
        s_step.reshape(n_seg, seg, B),
        ent_idx.reshape(n_seg, seg, B),
        o_all[:, 0],
    )


@partial(jax.jit, static_argnames=("band",))
def _myers_init(b, b_len, a_len, o0, band: int):
    """Initial Myers state at row 0 (window at o0)."""
    B, LB = b.shape[0], b.shape[1]
    # D(0, j) = j: every vertical delta +1
    ones32 = jnp.full((B,), 0xFFFFFFFF, jnp.uint32)
    zeros32 = jnp.zeros((B,), jnp.uint32)
    VP0 = (ones32,) * NW
    VN0 = (zeros32,) * NW
    sf0 = o0  # D(0, o0) = o0
    # Peq bit u of word k <-> column j = o + 32k + u + 1, char b[j-1]
    pos0 = o0[:, None] + jnp.arange(band, dtype=jnp.int32)[None, :]  # b index
    bch0 = jnp.take_along_axis(b, jnp.clip(pos0, 0, LB - 1), axis=1)
    Peq0 = tuple(
        _pack_bits((bch0 == c) & (pos0 < LB)) for c in range(4)
    )  # 4 chars x NW planes of [B]

    # row-0 B-exhaustion (b_len inside the initial window)
    wb0 = b_len - o0
    in0 = (wb0 >= 0) & (wb0 < band)
    best_bx0 = jnp.where(in0, _masked_score(VP0, VN0, sf0, jnp.maximum(wb0, 0)), INF)
    # row-0 A-exhaustion capture (a_len == 0)
    fin0 = a_len == 0
    z32 = jnp.zeros(B, jnp.int32)

    return (
        VP0, VN0, Peq0, sf0, o0,
        best_bx0, z32, jnp.where(in0, b_len, 0),
        _sel(fin0, VP0, (zeros32,) * NW),
        _sel(fin0, VN0, (zeros32,) * NW),
        jnp.where(fin0, sf0, 0), jnp.where(fin0, o0, 0),
        # partial-extension tracker: (ext=a+b, edits, a, b) best so far —
        # the (0,0) start is always admissible at 0 edits
        z32, z32, z32, z32,
    )


@partial(jax.jit, static_argnames=("band", "seg"), donate_argnums=(0,))
def _myers_segment(carry, a, b, s_seg, ent_seg, a_len, b_len, i0, cap_q,
                   band: int, seg: int):
    """Run `seg` Myers rows starting after absolute row i0.

    a uint8[B, LA], b uint8[B, LB]; s_seg/ent_seg [seg, B] from
    _myers_prep.  The program shape depends only on (B, LA, LB, seg), so
    one compile serves every segment of every chunk.
    """
    B, LB = b.shape[0], b.shape[1]
    # entering chars for the whole segment in one gather: [B, seg]
    ent = jnp.clip(ent_seg.T, 0, LB - 1)
    b_in = jnp.take_along_axis(b, ent, axis=1).astype(jnp.uint8).T  # [seg, B]
    a_seg = jax.lax.dynamic_slice(
        a, (0, i0), (B, seg)
    ).astype(jnp.uint8).T  # rows i0+1..i0+seg use a[:, i0:i0+seg]
    steps = i0 + 1 + jnp.arange(seg, dtype=jnp.int32)

    u1 = jnp.uint32(1)
    u31 = jnp.uint32(31)

    def step(carry, xs):
        (VP, VN, Peq, sf, o,
         best_bx, aend_bx, bend_bx, finVP, finVN, fin_sf, fin_o,
         p_ext, p_edits, p_a, p_b) = carry
        s, ach, bch, i = xs
        live = i <= a_len  # [B]
        s = jnp.where(live, s.astype(jnp.int32), 0)
        do_shift = s > 0

        # ---- window shift (elementwise; per-lane condition) ----
        # the column that becomes the window's first cell after a shift
        # keeps its diagonal from the column that leaves: D(i, o_i) =
        # min(D(i-1, o_i) + 1, D(i-1, o_i - 1) + sub), as in banded_extend
        sub0 = (_eq_bit0(Peq, ach) ^ u1).astype(jnp.int32)
        dg0 = sf + sub0
        sf_sh = sf + (VP[0] & u1).astype(jnp.int32) - (VN[0] & u1).astype(jnp.int32)
        onesB = jnp.ones(B, jnp.uint32)
        zerosB = jnp.zeros(B, jnp.uint32)
        VP_sh = _shift_chain(VP, onesB)  # below-band wall: +1
        VN_sh = _shift_chain(VN, zerosB)
        Peq_sh = tuple(
            _shift_chain(Peq[c], (bch.astype(jnp.int32) == c).astype(jnp.uint32))
            for c in range(4)
        )
        VP = _sel(do_shift, VP_sh, VP)
        VN = _sel(do_shift, VN_sh, VN)
        Peq = tuple(_sel(do_shift, Peq_sh[c], Peq[c]) for c in range(4))
        sf = jnp.where(do_shift, sf_sh, sf)
        o = o + s

        # ---- Myers column update (edlib calculateBlock chained) ----
        Eq_all = tuple(
            jnp.where(ach == 0, Peq[0][k], 0)
            | jnp.where(ach == 1, Peq[1][k], 0)
            | jnp.where(ach == 2, Peq[2][k], 0)
            | jnp.where(ach == 3, Peq[3][k], 0)
            for k in range(NW)
        )
        # boundary cell D(i, o): +1/row below D(i-1, o), or the diagonal
        # of the dropped column when the window just moved (hin in -1..1)
        hin = jnp.where(do_shift, jnp.minimum(dg0 - sf, 1), 1)
        hp_in = (hin > 0).astype(jnp.uint32)
        hm_in = (hin < 0).astype(jnp.uint32)
        nVP, nVN = [], []
        for k in range(NW):
            Pv, Mv = VP[k], VN[k]
            Xv = Eq_all[k] | Mv
            Eq = Eq_all[k] | hm_in  # hin<0 sets Eq bit 0
            Xh = ((Eq & Pv) + Pv ^ Pv) | Eq
            Ph = Mv | ~(Xh | Pv)
            Mh = Pv & Xh
            hp_out = Ph >> u31
            hm_out = Mh >> u31
            Ph = (Ph << u1) | hp_in
            Mh = (Mh << u1) | hm_in
            nVP.append(Mh | ~(Xv | Ph))
            nVN.append(Ph & Xv)
            hp_in, hm_in = hp_out, hm_out
        sf_new = sf + hin

        VP = _sel(live, tuple(nVP), VP)
        VN = _sel(live, tuple(nVN), VN)
        sf = jnp.where(live, sf_new, sf)

        # ---- B-exhaustion capture: column j == b_len in-window ----
        wb = b_len - o
        inw = (wb >= 0) & (wb < band) & live
        cost = jnp.where(inw, _masked_score(VP, VN, sf, jnp.clip(wb, 0, band)), INF)
        better = cost < best_bx
        best_bx = jnp.where(better, cost, best_bx)
        aend_bx = jnp.where(better, i, aend_bx)
        bend_bx = jnp.where(better, b_len, bend_bx)

        # ---- A-exhaustion capture ----
        at_fin = i == a_len
        finVP = _sel(at_fin, VP, finVP)
        finVN = _sel(at_fin, VN, finVN)
        fin_sf = jnp.where(at_fin, sf, fin_sf)
        fin_o = jnp.where(at_fin, o, fin_o)

        # ---- best partial endpoint along the band center (the anchor
        # diagonal): furthest (i, j) with edits within the erate envelope
        # — the reference's overlapInCore -G partial-overlap mode
        # (/root/reference/src/overlapInCore/overlapInCore.C, forOBT) ----
        jc = o + band // 2
        sc = sf
        for kk in range(NW // 2):  # static prefix: first band/2 columns
            sc = sc + jax.lax.population_count(VP[kk]).astype(jnp.int32)
            sc = sc - jax.lax.population_count(VN[kk]).astype(jnp.int32)
        ext = i + jc
        # int32-safe: edits beyond 80k can't meet any sane envelope for
        # reads this kernel sees (<=2^21 bases -> cap_q*ext < 2^31)
        sc_c = jnp.minimum(sc, 80_000)
        ext_c = jnp.minimum(ext, 400_000)  # conservative past ~200 kbp
        ok = (jc <= b_len) & live & (sc_c * 20000 <= cap_q * ext_c) & (ext > p_ext)
        p_ext = jnp.where(ok, ext, p_ext)
        p_edits = jnp.where(ok, sc, p_edits)
        p_a = jnp.where(ok, i, p_a)
        p_b = jnp.where(ok, jc, p_b)

        new = (VP, VN, Peq, sf, o,
               best_bx, aend_bx, bend_bx, finVP, finVN, fin_sf, fin_o,
               p_ext, p_edits, p_a, p_b)
        return new, None

    # unroll: the work per step is ~100 small [B] vector ops, so the
    # while-loop's per-iteration overhead can dominate; unrolling packs
    # UNROLL rows per loop iteration
    carry, _ = jax.lax.scan(step, carry, (s_seg, a_seg, b_in, steps),
                            unroll=UNROLL)
    return carry


@partial(jax.jit, static_argnames=("band",))
def _myers_finish(carry, a_len, b_len, band: int):
    """Pick the best extension end from the final carry."""
    (_, _, _, _, _,
     best_bx, aend_bx, bend_bx, finVP, finVN, fin_sf, fin_o,
     p_ext, p_edits, p_a, p_b) = carry

    # ---- A-exhausted row: unpack and take the best in-window column ----
    dv = _unpack_bits(finVP) - _unpack_bits(finVN)  # [B, 128]
    pref = jnp.cumsum(dv, axis=1)
    w_ramp = jnp.arange(band, dtype=jnp.int32)[None, :]
    scores = fin_sf[:, None] + jnp.where(w_ramp == 0, 0, jnp.roll(pref, 1, axis=1))
    # D(fin row, fin_o + w); valid while the column exists on B
    j = fin_o[:, None] + w_ramp
    scores = jnp.where(j <= b_len[:, None], scores, INF)
    wbest = jnp.argmin(scores, axis=1).astype(jnp.int32)
    cost_ax = jnp.take_along_axis(scores, wbest[:, None], axis=1)[:, 0]
    bend_ax = fin_o + wbest

    use_ax = cost_ax <= best_bx
    edits = jnp.where(use_ax, cost_ax, best_bx)
    a_used = jnp.where(use_ax, a_len, aend_bx)
    b_used = jnp.where(use_ax, bend_ax, bend_bx)
    # partial endpoints never exceed the reads
    p_a = jnp.minimum(p_a, a_len)
    p_b = jnp.minimum(p_b, b_len)
    return edits, a_used, b_used, p_edits, p_a, p_b


@partial(jax.jit, static_argnames=("n_rows",))
def _pack_inputs(a, b, s_segs, ent_segs, n_rows: int):
    """Packed Triton-kernel inputs (see pallas.myers_triton), row-major
    with the pairs minor so a block of pairs loads contiguously:

      sa  [n_rows/8, B] u32 — 8 rows x (shift | a_chr<<1), 3 b/row;
      ew0/ew1 [n_rows/16, B] u32 — 2-bit-packed B words covering
        the <=16 entering chars of each 16-row block (+ the next word);
      bw  [n_rows/16, B] u32 — B position of ew0 bit 0.

    The entering-char fetch is 2 words per 16 rows instead of one
    gathered char per row, so the kernel itself does no gather."""
    n_seg, seg, B = s_segs.shape
    s = s_segs.reshape(n_seg * seg, B)[:n_rows].astype(jnp.uint32)
    a_rows = a[:, :n_rows].astype(jnp.uint32).T
    v = (s | (a_rows << jnp.uint32(1))).reshape(n_rows // 8, 8, B)
    sh = (3 * jnp.arange(8, dtype=jnp.uint32))[None, :, None]
    sa = jnp.sum(v << sh, axis=1, dtype=jnp.uint32)

    ent = ent_segs.reshape(n_seg * seg, B)[:n_rows]  # e = o(i+1) + 127
    e0 = ent[::16]  # [n_blocks, B]; block advance <= 15 chars
    LB = b.shape[1]
    nw2 = -(-LB // 16) + 1
    bp = jnp.pad(b, ((0, 0), (0, nw2 * 16 - LB))).astype(jnp.uint32)
    shw = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    bpk = jnp.sum(bp.reshape(B, nw2, 16) << shw, axis=2, dtype=jnp.uint32)
    widx = jnp.clip(e0 >> 4, 0, nw2 - 2)
    ew0 = jnp.take_along_axis(bpk, widx.T, axis=1).T
    ew1 = jnp.take_along_axis(bpk, widx.T + 1, axis=1).T
    bw = (widx << 4).astype(jnp.uint32)
    return sa, ew0, ew1, bw


@jax.jit
def _carry_pack(carry):
    """XLA carry tuple ([B] planes) -> [NC, B] u32."""
    (VP, VN, Peq, sf, o, best_bx, aend_bx, bend_bx,
     finVP, finVN, fin_sf, fin_o, p_ext, p_edits, p_a, p_b) = carry
    planes = (list(VP) + list(VN)
              + [w for c in range(4) for w in Peq[c]]
              + [sf, o, best_bx, aend_bx, bend_bx]
              + list(finVP) + list(finVN)
              + [fin_sf, fin_o, p_ext, p_edits, p_a, p_b])
    return jnp.stack([p.astype(jnp.uint32) for p in planes])


@jax.jit
def _carry_unpack(fl):
    """[NC, B] u32 -> the XLA carry tuple ([B] planes)."""

    def u(i):
        return fl[i]

    def s(i):
        return fl[i].astype(jnp.int32)

    k = NW
    VP = tuple(u(i) for i in range(0, k))
    VN = tuple(u(i) for i in range(k, 2 * k))
    Peq = tuple(tuple(u(2 * k + 4 * c + w) for w in range(k)) for c in range(4))
    base = 2 * k + 4 * k
    finVP = tuple(u(base + 5 + i) for i in range(k))
    finVN = tuple(u(base + 5 + k + i) for i in range(k))
    b2 = base + 5 + 2 * k
    return (VP, VN, Peq, s(base), s(base + 1), s(base + 2), s(base + 3),
            s(base + 4), finVP, finVN, s(b2), s(b2 + 1), s(b2 + 2),
            s(b2 + 3), s(b2 + 4), s(b2 + 5))


def _run_triton(a, a_len, b, b_len, centers, band: int, seg: int,
                n_seg: int, run_segs: int, cap_q, interpret: bool = False):
    """Triton path: prep, pack and init in XLA, the whole row loop in
    ONE kernel launch, finish in XLA."""
    from .pallas.myers_triton import BLOCK, myers_run_triton

    B = a.shape[0]
    pad = (-B) % BLOCK
    if pad:
        a = jnp.pad(a, ((0, pad), (0, 0)))
        b = jnp.pad(b, ((0, pad), (0, 0)))
        a_len = jnp.pad(a_len, (0, pad))
        b_len = jnp.pad(b_len, (0, pad))
        centers = jnp.pad(centers, ((0, pad), (0, 0)))
    # pow2-quantize the live segment count: one compiled kernel per
    # (padded B, rows) pair
    runq = 1
    while runq < run_segs:
        runq *= 2
    runq = min(runq, n_seg)
    s_segs, ent_segs, o0 = _myers_prep(b_len, centers, band, n_seg, seg)
    sa, ew0, ew1, bw = _pack_inputs(a, b, s_segs, ent_segs, runq * seg)
    carry0 = _carry_pack(_myers_init(b, b_len, a_len, o0, band))
    out = myers_run_triton(carry0, sa, ew0, ew1, bw, a_len, b_len,
                           jnp.int32(cap_q), interpret=interpret)
    res = _myers_finish(_carry_unpack(out), a_len, b_len, band)
    if pad:
        res = tuple(r[:B] for r in res)
    return res


def default_impl() -> str:
    """The verify engine for the default backend: the Triton kernel on a
    GPU, the XLA scan everywhere else."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


def banded_extend_myers(
    a: jax.Array,  # uint8[B, LA] (row 0 = first char to align)
    a_len: jax.Array,  # int32[B]
    b: jax.Array,  # uint8[B, LB]
    b_len: jax.Array,  # int32[B]
    centers: jax.Array,  # int32[B, n_rows+1]
    band: int = 128,
    n_rows: int = 0,
    segment: int = SEGMENT,
    max_rows: int | None = None,
    partial_cap_q: int | None = None,
    impl: str | None = None,
):
    """Drop-in equivalent of banded_extend (band must be 128).

    HOST-LEVEL orchestrator (not jittable, by design): prep and init are
    one small dispatch each, then the row loop, then one finish dispatch.
    impl "xla" runs the loop as ceil(rows/segment) fixed-shape segment
    dispatches that stream asynchronously; impl "triton" runs it as one
    kernel launch ("triton_interpret": the same kernel interpreted, for
    CPU tests); None takes default_impl().  Pass max_rows (host int,
    e.g. lengths.max()) to skip rows past every pair's end.

    partial_cap_q: when set (erate in 0.01% fixed-point), ALSO track the
    furthest band-center endpoint whose edit count stays within that
    error envelope and return a 6-tuple (edits, a_used, b_used,
    p_edits, p_a, p_b) — the reference's partial-overlap (-G / forOBT)
    semantics.  When None, returns the classic 3-tuple.
    """
    assert band == NW * WORD, "Myers kernel is specialized to band=128"
    seg = min(segment, n_rows) if n_rows else segment
    n_seg = max(1, -(-n_rows // seg))
    a_len = a_len.astype(jnp.int32)
    b_len = b_len.astype(jnp.int32)
    # a must cover n_seg*seg slice range
    need = n_seg * seg
    if a.shape[1] < need:
        a = jnp.pad(a, ((0, 0), (0, need - a.shape[1])))
    run_segs = n_seg
    if max_rows is not None:
        run_segs = max(1, min(n_seg, -(-int(max_rows) // seg)))
    # kernel condition is edits*20000 <= cap_q*(a+b), i.e. edits within
    # cap_q (0.01% fixed-point) of the mean-span (a+b)/2
    cap_q = jnp.int32(0 if partial_cap_q is None else int(partial_cap_q))
    if impl is None:
        impl = default_impl()
    if impl in ("triton", "triton_interpret"):
        out = _run_triton(
            a, a_len, b, b_len, centers, band, seg, n_seg, run_segs, cap_q,
            interpret=(impl == "triton_interpret"),
        )
        return out if partial_cap_q is not None else out[:3]
    assert impl == "xla", f"unknown Myers impl {impl!r}"
    s_segs, ent_segs, o0 = _myers_prep(b_len, centers, band, n_seg, seg)
    carry = _myers_init(b, b_len, a_len, o0, band)
    for t in range(run_segs):
        carry = _myers_segment(
            carry, a, b, s_segs[t], ent_segs[t], a_len, b_len,
            jnp.int32(t * seg), cap_q, band, seg,
        )
    out = _myers_finish(carry, a_len, b_len, band)
    return out if partial_cap_q is not None else out[:3]
