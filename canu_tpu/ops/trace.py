"""Base-level alignment positions via forward+backward banded DP.

The falcon-sense/utgcns consensus path needs, for every evidence read
aligned to a template, the evidence coordinate at EVERY template
position (to vote bases/deletions/insertions).  The reference gets this
from alignment tracebacks (falconConsensus-alignTag.C, edlib paths); a
sequential traceback maps poorly to batched device code, so instead:

    run the banded DP FORWARD (cost of aligning prefixes) and BACKWARD
    (cost of aligning suffixes); a cell is on an optimal path iff
    fwd(i,j) + bwd(i,j) equals the total cost, so the per-row argmin of
    fwd+bwd gives the evidence position j*(i) for every template row i
    in one vectorized pass — no traceback, no per-step host work.

j* is monotonized; consecutive equal j* = deletion in the evidence,
jumps > 1 = insertions.  Ambiguous-path ties diffuse a vote
occasionally, which plurality voting over ~40x evidence absorbs.

Alignment is GLOBAL over the given spans (both ends pinned), matching
how the reference aligns evidence to a template layout span
(/root/reference/src/correction/falconConsensus.C).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

INF16 = 30000  # python int (see align.py note)
SMAX = 4


def _band_starts(centers, b_len, band):
    o = jnp.clip(centers - band // 2, 0, jnp.maximum(b_len, 0)[:, None])
    o = jax.lax.associative_scan(jnp.maximum, o, axis=1)
    ramp = SMAX * jnp.arange(o.shape[1], dtype=jnp.int32)[None, :]
    return jax.lax.associative_scan(jnp.minimum, o - ramp, axis=1) + ramp


@partial(jax.jit, static_argnames=("band", "n_rows"))
def align_positions(
    t: jax.Array,  # uint8[B, LT] template chars (row 0 = first char)
    t_len: jax.Array,  # int32[B]
    e: jax.Array,  # uint8[B, LE] evidence chars
    e_len: jax.Array,  # int32[B]
    centers: jax.Array,  # int32[B, n_rows+1]
    band: int,
    n_rows: int,
):
    """Returns (j_star int32[B, n_rows+1], edits int32[B]).

    j_star[b, i] = evidence position aligned at template position i on an
    optimal global path (monotonic non-decreasing); rows beyond t_len
    hold e_len.
    """
    B = t.shape[0]
    w_ramp = jnp.arange(band, dtype=jnp.int32)[None, :]
    o_all = _band_starts(centers, e_len, band)

    def char_sub(i):
        # substitution cost vector for row i: t[i-1] vs e[j-1], j = o(i)+w
        o_i = jax.lax.dynamic_slice_in_dim(o_all, i, 1, axis=1)[:, 0]
        j = o_i[:, None] + w_ramp
        t_chr = jax.lax.dynamic_slice_in_dim(t, i - 1, 1, axis=1)
        e_idx = jnp.clip(j - 1, 0, e.shape[1] - 1)
        e_chr = jnp.take_along_axis(e, e_idx, axis=1)
        return o_i, j, (t_chr != e_chr).astype(jnp.int32)

    # ---- forward: F(i, j) = cost aligning t[:i] with e[:j] ----
    o0 = o_all[:, 0:1]
    j0 = o0 + w_ramp
    F0 = jnp.where(j0 <= e_len[:, None], j0, INF16)

    def f_step(F_prev, i):
        o_i = jax.lax.dynamic_slice_in_dim(o_all, i, 1, axis=1)[:, 0]
        o_im1 = jax.lax.dynamic_slice_in_dim(o_all, i - 1, 1, axis=1)[:, 0]
        s = (o_i - o_im1)[:, None]
        idx_up = w_ramp + s
        idx_dg = idx_up - 1
        up = jnp.where(
            (idx_up >= 0) & (idx_up < band),
            jnp.take_along_axis(F_prev, jnp.clip(idx_up, 0, band - 1), axis=1), INF16)
        dg = jnp.where(
            (idx_dg >= 0) & (idx_dg < band),
            jnp.take_along_axis(F_prev, jnp.clip(idx_dg, 0, band - 1), axis=1), INF16)
        _, j, sub = char_sub(i)
        valid_dg = (j >= 1) & (j <= e_len[:, None])
        m = jnp.minimum(up + 1, jnp.where(valid_dg, dg + sub, INF16))
        r = jax.lax.associative_scan(jnp.minimum, jnp.minimum(m - w_ramp, INF16), axis=1)
        F = jnp.minimum(r + w_ramp, INF16)
        F = jnp.where((j <= e_len[:, None]) & (i <= t_len)[:, None], F, INF16)
        return F, F

    _, F_rows = jax.lax.scan(f_step, F0, jnp.arange(1, n_rows + 1, dtype=jnp.int32))
    F_rows = jnp.concatenate([F0[None], F_rows], axis=0)  # [n_rows+1, B, band]

    # ---- backward: G(i, j) = cost aligning t[i:t_len] with e[j:e_len] ----
    def g_init_row(i):
        o_i = jax.lax.dynamic_slice_in_dim(o_all, i, 1, axis=1)[:, 0]
        j = o_i[:, None] + w_ramp
        return jnp.where(j <= e_len[:, None], e_len[:, None] - j, INF16)

    # scan downward i = n_rows-1 .. 0; carry = G(i+1) row
    G_top = g_init_row(n_rows)  # row n_rows (i == t_len only if t_len == n_rows)
    G_top = jnp.where((t_len == n_rows)[:, None], G_top, INF16)

    def g_step(G_next, i):
        o_i = jax.lax.dynamic_slice_in_dim(o_all, i, 1, axis=1)[:, 0]
        o_ip1 = jax.lax.dynamic_slice_in_dim(o_all, i + 1, 1, axis=1)[:, 0]
        s = (o_ip1 - o_i)[:, None]  # >= 0
        j = o_i[:, None] + w_ramp
        # G(i+1, j): lane in next row = j - o(i+1) = w - s
        idx_dn = w_ramp - s
        dn = jnp.where(
            (idx_dn >= 0) & (idx_dn < band),
            jnp.take_along_axis(G_next, jnp.clip(idx_dn, 0, band - 1), axis=1), INF16)
        # G(i+1, j+1): lane w - s + 1; sub cost uses t[i], e[j]
        idx_dg = idx_dn + 1
        dg = jnp.where(
            (idx_dg >= 0) & (idx_dg < band),
            jnp.take_along_axis(G_next, jnp.clip(idx_dg, 0, band - 1), axis=1), INF16)
        t_chr = jax.lax.dynamic_slice_in_dim(t, i, 1, axis=1)
        e_idx = jnp.clip(j, 0, e.shape[1] - 1)
        e_chr = jnp.take_along_axis(e, e_idx, axis=1)
        sub = (t_chr != e_chr).astype(jnp.int32)
        valid_dg = j < e_len[:, None]
        m = jnp.minimum(dn + 1, jnp.where(valid_dg, dg + sub, INF16))
        # rightward closure: G(i, j) can also come from G(i, j+1) + 1:
        # G[w] = min_{w'>=w}(m[w'] + (w'-w)) = suffix_min(m + w) - w
        rev = jnp.flip(jnp.minimum(m + w_ramp, INF16), axis=1)
        sm = jax.lax.associative_scan(jnp.minimum, rev, axis=1)
        G = jnp.minimum(jnp.flip(sm, axis=1) - w_ramp, INF16)
        G = jnp.where((j <= e_len[:, None]) & (j >= 0), G, INF16)
        # pin: at i == t_len the row is the boundary init, not the recurrence
        bound = jnp.where(j <= e_len[:, None], e_len[:, None] - j, INF16)
        G = jnp.where((i == t_len)[:, None], bound, G)
        G = jnp.where((i > t_len)[:, None], INF16, G)
        return G, G

    _, G_rows_rev = jax.lax.scan(
        g_step, G_top, jnp.arange(n_rows - 1, -1, -1, dtype=jnp.int32)
    )
    G_rows = jnp.concatenate(
        [jnp.flip(G_rows_rev, axis=0), G_top[None]], axis=0
    )  # [n_rows+1, B, band]

    # ---- combine: per-row argmin of F+G over the band ----
    total = F_rows + G_rows  # [n_rows+1, B, band]
    w_star = jnp.argmin(total, axis=2).astype(jnp.int32)  # [n_rows+1, B]
    row_min = jnp.min(total, axis=2)  # [n_rows+1, B]
    o_T = jnp.transpose(o_all, (1, 0))  # [n_rows+1, B]
    j_star = jnp.transpose(o_T + w_star, (1, 0))  # [B, n_rows+1]
    ri = jnp.arange(n_rows + 1, dtype=jnp.int32)[None, :]
    live = ri <= t_len[:, None]
    j_star = jnp.where(live, j_star, e_len[:, None])
    # enforce monotone non-decreasing (ambiguity can wobble at ties)
    j_star = jax.lax.associative_scan(jnp.maximum, j_star, axis=1)
    j_star = jnp.minimum(j_star, e_len[:, None])
    edits = jnp.min(jnp.where(jnp.transpose(live, (1, 0)), row_min, INF16), axis=0)
    return j_star, edits


# rows per window anchor in align_positions_lean: the band start is
# re-based every SROW rows so the inner DP steps use ONLY static shifts
# instead of a per-step take_along_axis gather inside the lax.scan
# (their relative cost on the H100 is not measured)
SROW = 32


@partial(jax.jit, static_argnames=("band", "n_rows", "ends_free"))
def align_positions_lean(
    t: jax.Array,  # uint8[B, >=n_rows] template chars (row 0 = first char)
    t_len: jax.Array,  # int32[B]
    e: jax.Array,  # uint8[B, LE] evidence chars
    e_len: jax.Array,  # int32[B]
    band: int,
    n_rows: int,
    ends_free: bool = False,
):
    """Memory-lean banded DP for the device vote engine (window-frame).

    ``ends_free=True`` makes evidence start/end gaps cost 0 (edlib HW
    mode: the template window aligns as an infix of the evidence
    window).  Consensus polish and segmented correction use this —
    evidence windows carry slack that must not be force-fitted.

    Design (v2): template rows are processed in SUPER-ROWS of SROW
    rows sharing one window anchor a_p (the band start of the
    super-row's first row).  Band starts are monotone with increments
    <= SMAX (enforced by _band_starts), so all SROW rows' bands live in
    a window of Ww = band + SMAX*SROW lanes anchored at a_p.  Within a
    super-row the DP recurrences are pure lane-static ops:

      * template gap  : same lane (no shift at all);
      * diagonal      : one static shift;
      * evidence chars: ONE take_along_axis per super-row fetches the
        whole window; per-row chars are static shifts of it;
      * evidence gap  : prefix/suffix-min closure over lanes.

    The outer lax.scan runs over super-rows with the inner SROW steps
    unrolled (one loop level, not a nested scan).  Re-anchoring between
    super-rows is a log-round masked shift.  Forward rows are stored
    window-normalized uint8 (255 = out-of-band/INF); the backward pass
    folds the F+G combine in, emitting only the per-row optimal
    evidence position j*.

    Returns (j_star int32[B, n_rows+1], edits int32[B]).  Requires
    band <= 256 and n_rows % SROW == 0.
    """
    assert band <= 256, "uint8 row normalization requires band <= 256"
    assert n_rows % SROW == 0, "n_rows must be a multiple of SROW"
    R = SROW
    Q = n_rows // R
    Ww = band + SMAX * R
    B = t.shape[0]
    x_ramp = jnp.arange(Ww, dtype=jnp.int32)[None, :]
    ri = jnp.arange(n_rows + 1, dtype=jnp.int32)
    tl = jnp.maximum(t_len, 1)[:, None]
    centers = jnp.minimum(
        (ri[None, :] * e_len[:, None] + tl // 2) // tl, e_len[:, None]
    ).astype(jnp.int32)
    o_all = _band_starts(centers, e_len, band)  # [B, n_rows+1]
    A = o_all[:, ::R][:, :Q]  # anchors a_p = o_all[:, p*R]
    el = e_len[:, None]
    EW = Ww + 128  # evidence fetch covers e[a_p-1 .. a_p+Ww+126]
    ew_ramp = jnp.arange(EW, dtype=jnp.int32)[None, :]
    D_MAX = SMAX * R  # max re-anchor shift

    # one sentinel column so the window can reach e[a-1] even at a == 0
    # (that lane is only read under valid_dg == False)
    e_pad = jnp.concatenate([jnp.zeros((B, 1), e.dtype), e], axis=1)

    def fetch_ewin(a):
        # window e[a-1 .. a-1+EW) per row via masked log-shifts of the
        # sentinel-padded evidence instead of a 2D gather inside the scan
        x = e_pad
        j = 0
        while (1 << j) < x.shape[1]:
            s = 1 << j
            sh = jnp.concatenate(
                [x[:, s:], jnp.zeros((B, s), x.dtype)], axis=1)
            x = jnp.where((((a >> j) & 1) == 1)[:, None], sh, x)
            j += 1
        if x.shape[1] < EW:
            x = jnp.pad(x, ((0, 0), (0, EW - x.shape[1])))
        return x[:, :EW]  # [B, EW]: lane x holds e[a - 1 + x]

    def shift_rows(Fw, d, left: bool):
        """Per-row shift by d in [0, D_MAX], INF16 fill — log rounds."""
        j = 0
        while (1 << j) <= D_MAX:
            s = 1 << j
            if s < Ww:
                if left:
                    sh = jnp.concatenate(
                        [Fw[:, s:], jnp.full((B, s), INF16, Fw.dtype)], axis=1)
                else:
                    sh = jnp.concatenate(
                        [jnp.full((B, s), INF16, Fw.dtype), Fw[:, :-s]], axis=1)
            else:
                sh = jnp.full_like(Fw, INF16)
            Fw = jnp.where((((d >> j) & 1) == 1)[:, None], sh, Fw)
            j += 1
        return Fw

    def norm(F):
        fmin = jnp.min(F, axis=1)
        d = jnp.clip(F - fmin[:, None], 0, 254).astype(jnp.uint8)
        d = jnp.where(F >= INF16, jnp.uint8(255), d)
        return d, fmin

    # ---- forward ----
    a0 = A[:, 0]
    j0 = a0[:, None] + x_ramp
    F0 = jnp.where(j0 <= el, jnp.zeros_like(j0) if ends_free else j0, INF16)
    u0, m0 = norm(F0)

    def f_row(F_prev, Ewin, a_p, i):
        """F(i) from F(i-1), both in frame a_p.  i is a traced scalar."""
        j = a_p[:, None] + x_ramp
        up = F_prev + 1
        dg = jnp.concatenate(
            [jnp.full((B, 1), INF16, jnp.int32), F_prev[:, :-1]], axis=1)
        t_chr = jax.lax.dynamic_slice_in_dim(t, i - 1, 1, axis=1)
        sub = (t_chr != Ewin[:, :Ww]).astype(jnp.int32)  # e[j-1]
        valid_dg = (j >= 1) & (j <= el)
        m = jnp.minimum(up, jnp.where(valid_dg, dg + sub, INF16))
        r = jax.lax.associative_scan(
            jnp.minimum, jnp.minimum(m - x_ramp, INF16), axis=1)
        F = jnp.minimum(r + x_ramp, INF16)
        return jnp.where((j <= el) & (i <= t_len)[:, None], F, INF16)

    def f_body(Fw, p):
        a_pm1 = jax.lax.dynamic_index_in_dim(A, jnp.maximum(p - 1, 0), axis=1,
                                             keepdims=False)
        a_p = jax.lax.dynamic_index_in_dim(A, p, axis=1, keepdims=False)
        Fw = shift_rows(Fw, a_p - a_pm1, left=True)
        Ewin = fetch_ewin(a_p)
        us, ms = [], []
        for r_ in range(1, R + 1):
            Fw = f_row(Fw, Ewin, a_p, p * R + r_)
            u, m = norm(Fw)
            us.append(u)
            ms.append(m)
        return Fw, (jnp.stack(us), jnp.stack(ms))

    _F_top, (Fu_q, Fm_q) = jax.lax.scan(
        f_body, F0, jnp.arange(Q, dtype=jnp.int32)
    )
    Fu_flat = Fu_q.reshape(Q * R, B, Ww)  # row i at index i-1
    Fm_flat = Fm_q.reshape(Q * R, B)

    # ---- backward with fused combine ----
    def combine(i, a_p, G_i):
        iz = jnp.maximum(i - 1, 0)
        Fu = jax.lax.dynamic_index_in_dim(Fu_flat, iz, axis=0, keepdims=False)
        Fm = jax.lax.dynamic_index_in_dim(Fm_flat, iz, axis=0, keepdims=False)
        Fu = jnp.where(i == 0, u0, Fu)
        Fm = jnp.where(i == 0, m0, Fm)
        tot = Fm[:, None] + Fu.astype(jnp.int32) + G_i
        bad = (Fu == 255) | (G_i >= INF16) | (Fm >= INF16)[:, None]
        tot = jnp.where(bad, INF16 * 4, tot)
        x_star = jnp.argmin(tot, axis=1).astype(jnp.int32)
        return a_p + x_star, jnp.min(tot, axis=1)

    def g_row(G_next, Ewin, a_p, i):
        """G(i) from G(i+1), both in frame a_p.  i is a traced scalar."""
        j = a_p[:, None] + x_ramp
        dn = G_next + 1
        dg = jnp.concatenate(
            [G_next[:, 1:], jnp.full((B, 1), INF16, jnp.int32)], axis=1)
        t_chr = jax.lax.dynamic_slice_in_dim(t, i, 1, axis=1)
        sub = (t_chr != Ewin[:, 1 : Ww + 1]).astype(jnp.int32)  # e[j] at x
        valid_dg = j < el
        m = jnp.minimum(dn, jnp.where(valid_dg, dg + sub, INF16))
        rev = jnp.flip(jnp.minimum(m + x_ramp, INF16), axis=1)
        sm = jax.lax.associative_scan(jnp.minimum, rev, axis=1)
        G = jnp.minimum(jnp.flip(sm, axis=1) - x_ramp, INF16)
        G = jnp.where(j <= el, G, INF16)
        tail = jnp.zeros_like(j) if ends_free else el - j
        bound = jnp.where(j <= el, tail, INF16)
        G = jnp.where((i == t_len)[:, None], bound, G)
        return jnp.where((i > t_len)[:, None], INF16, G)

    a_top = A[:, Q - 1]
    j_top_full = a_top[:, None] + x_ramp
    tail0 = jnp.zeros_like(j_top_full) if ends_free else el - j_top_full
    G_top = jnp.where(j_top_full <= el, tail0, INF16)
    G_top = jnp.where((t_len == n_rows)[:, None], G_top, INF16)
    j_top, ed_top = combine(jnp.int32(n_rows), a_top, G_top)
    edits0 = jnp.where(t_len == n_rows, ed_top, INF16 * 4)

    def g_body(carry, p):
        G, edits = carry
        a_p = jax.lax.dynamic_index_in_dim(A, p, axis=1, keepdims=False)
        a_pm1 = jax.lax.dynamic_index_in_dim(A, jnp.maximum(p - 1, 0), axis=1,
                                             keepdims=False)
        Ewin = fetch_ewin(a_p)
        js_rows = [None] * R
        for r_ in range(R - 1, 0, -1):
            i = p * R + r_
            G = g_row(G, Ewin, a_p, i)
            j_i, row_min = combine(i, a_p, G)
            edits = jnp.where(i == t_len, row_min, edits)
            js_rows[r_] = j_i
        # row p*R lives in frame a_{p-1}: re-anchor then compute
        G = shift_rows(G, a_p - a_pm1, left=False)
        Ewin_prev = fetch_ewin(a_pm1)
        i = p * R
        G = g_row(G, Ewin_prev, a_pm1, i)
        j_i, row_min = combine(i, a_pm1, G)
        edits = jnp.where(i == t_len, row_min, edits)
        js_rows[0] = j_i
        return (G, edits), jnp.stack(js_rows)  # [R, B]

    (_, edits), js_q = jax.lax.scan(
        g_body, (G_top, edits0), jnp.arange(Q - 1, -1, -1, dtype=jnp.int32)
    )
    # js_q[s] = super-row p = Q-1-s -> flip to p order, flatten to rows
    js_flat = jnp.flip(js_q, axis=0).reshape(Q * R, B)  # rows 0..n_rows-1
    j_star = jnp.concatenate([js_flat, j_top[None]], axis=0)
    j_star = jnp.transpose(j_star, (1, 0))
    live = ri[None, :] <= t_len[:, None]
    j_star = jnp.where(live, j_star, e_len[:, None])
    j_star = jax.lax.associative_scan(jnp.maximum, j_star, axis=1)
    j_star = jnp.minimum(jnp.maximum(j_star, 0), e_len[:, None])
    return j_star, edits
