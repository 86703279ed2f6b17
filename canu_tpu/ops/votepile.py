"""Device vote-pile engine: batched evidence alignment + on-device voting.

This is the device core shared by read correction (falconsense,
/root/reference/src/correction/falconConsensus-alignTag.C), read error
detection (findErrors/RED, /root/reference/src/overlapErrorAdjustment/
findErrors.C:374-510) and consensus polish (utgcns/abAbacus role) — all
three reduce to: align many evidence windows onto template coordinates,
accumulate per-column votes (base/deletion/insertion), then call a
per-column plurality.

Round-1 did the voting on host (one np.add.at per evidence alignment),
which stalled at bacterial scale.  The device design:

  * evidence jobs are columnar host arrays of INDICES into device-
    resident packed-word planes; per chunk the host uploads a few KB of
    ids/coords, never sequence data;
  * alignment positions come from ops.trace.align_positions_lean
    (fwd+bwd banded DP, uint8-normalized forward rows);
  * votes are built as a one-hot contribution tensor [B, 10, Lt]
    (bfloat16; channels = 4 base + 1 del + 1 ins + 4 ins-base), shifted
    to template coordinates with log-round masked shifts, and folded
    into the per-block vote accumulator [G, 10, Lt] with ONE matmul
    (slot-one-hot [B, G]^T @ contrib) — the matrix unit does the
    scatter;
  * the plurality/RED decision runs on device and is fetched as ONE
    packed uint8 per template column, not as raw votes.

Counts are exact in float32 (integers < 2^24).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .kmer import unpack_bases
from .trace import align_positions_lean

# packed result bit layout (uint16; plurality mode — RED packs uint8)
#   bits 0-1: called base (plurality) / alt base (RED)
#   bits 2-3: first insertion base call (plurality) / bit2 = fix flag (RED)
#   bit 4: supported, bit 5: delete, bit 6: insert (before the base)
#   bit 7: second insertion, bits 8-9: second insertion base call
PB_CALL = 0
PB_INS_CALL = 2
PB_SUPPORTED = 4
PB_DELETE = 5
PB_INSERT = 6
PB_INSERT2 = 7
PB_INS2_CALL = 8

# vote channel layout along axis 1 of the [G, 15, Lt] accumulator.
# Two insertion slots per template column (the reference's alignTag MSA
# supports arbitrary insert runs, falconConsensus-alignTag.C; two per
# column per round covers the overwhelming mass of long-read indels, and
# iterative repileup absorbs the tail)
CH_BASE = 0  # ..3
CH_DEL = 4
CH_INS = 5
CH_INSBASE = 6  # ..9
CH_INS2 = 10
CH_INS2BASE = 11  # ..14
N_CH = 15


def _shift_rows_left(x: jax.Array, t: jax.Array, out_len: int) -> jax.Array:
    """out[b, i] = x[b, i + t[b]] (zero past the end), t >= 0 — log rounds."""
    B, L = x.shape
    if L < out_len:
        x = jnp.pad(x, ((0, 0), (0, out_len - L)))
        L = out_len
    t = t.astype(jnp.int32)
    j = 0
    while (1 << j) < L:
        s = 1 << j
        shifted = jnp.concatenate([x[:, s:], jnp.zeros((B, s), x.dtype)], axis=1)
        x = jnp.where((((t >> j) & 1) == 1)[:, None], shifted, x)
        j += 1
    return x[:, :out_len]


def _shift_rows_right(x: jax.Array, t: jax.Array, out_len: int) -> jax.Array:
    """out[b, i] = x[b, i - t[b]] for i >= t[b], zero before — log rounds."""
    B, L = x.shape
    if L < out_len:
        x = jnp.pad(x, ((0, 0), (0, out_len - L)))
        L = out_len
    x = x[:, :out_len]
    t = t.astype(jnp.int32)
    j = 0
    while (1 << j) < out_len:
        s = 1 << j
        shifted = jnp.concatenate(
            [jnp.zeros((B, s), x.dtype), x[:, :-s]], axis=1
        )
        x = jnp.where((((t >> j) & 1) == 1)[:, None], shifted, x)
        j += 1
    return x


def _gather_window(words: jax.Array, lengths: jax.Array, idx: jax.Array,
                   bgn: jax.Array, flipped, out_len: int) -> jax.Array:
    """Unpacked, oriented subsequence rows[idx][bgn : bgn+out_len].

    bgn is in ORIENTED coordinates (for flipped rows: distance from the
    read's 3' end).  flipped=None skips orientation entirely.
    """
    raw = unpack_bases(words[idx])
    L = raw.shape[1]
    if flipped is not None:
        ln = lengths[idx]
        rc = (3 - raw)[:, ::-1]
        ori = jnp.where(flipped[:, None], rc, raw)
        ori = _shift_rows_left(
            ori, jnp.where(flipped, L - ln, 0) + bgn, out_len
        )
        return ori
    return _shift_rows_left(raw, bgn, out_len)


def _vote_chunk_core(
    votes: jax.Array,  # f32[G, 15, Lt] accumulator
    t_words: jax.Array, t_lengths: jax.Array,
    e_words: jax.Array, e_lengths: jax.Array,
    t_idx: jax.Array, e_idx: jax.Array,  # int32[B] rows into the planes
    t_bgn: jax.Array, t_span: jax.Array,  # int32[B] template window
    e_lo: jax.Array, e_span: jax.Array,  # int32[B] oriented evidence window
    flipped: jax.Array,  # bool[B]
    slot: jax.Array,  # int32[B] template slot in the block
    weight: jax.Array,  # f32[B] per-job vote weight (QV tie-break)
    band: int, n_rows: int, Lt: int, G: int,
    ends_free: bool = False,
) -> jax.Array:
    """Align one chunk of evidence windows and fold votes into the block."""
    B = t_idx.shape[0]
    W_e = n_rows + max(band, n_rows // 2)
    t_sub = _gather_window(t_words, t_lengths, t_idx, t_bgn, None, n_rows)
    e_sub = _gather_window(e_words, e_lengths, e_idx, e_lo, flipped, W_e)
    e_span = jnp.minimum(e_span, W_e - 1)

    js, _ = align_positions_lean(t_sub, t_span, e_sub, e_span, band, n_rows,
                                 ends_free=ends_free)

    dj = js[:, 1:] - js[:, :-1]  # [B, n_rows]
    rowpos = jnp.arange(n_rows, dtype=jnp.int32)[None, :]
    live = rowpos < t_span[:, None]
    active = live & (js[:, 1:] > 0) & (js[:, :-1] < e_span[:, None])
    bidx = jnp.clip(js[:, 1:] - 1, 0, W_e - 1)
    bchr = jnp.take_along_axis(e_sub, bidx, axis=1)
    iidx = jnp.clip(js[:, :-1], 0, W_e - 1)
    ichr = jnp.take_along_axis(e_sub, iidx, axis=1)
    i2idx = jnp.clip(js[:, :-1] + 1, 0, W_e - 1)
    i2chr = jnp.take_along_axis(e_sub, i2idx, axis=1)
    m_base = active & (dj >= 1)
    m_del = active & (dj == 0)
    m_ins = active & (dj >= 2)
    m_ins2 = active & (dj >= 3)

    # Left-align deletion votes to template homopolymer run starts
    # (abAbacus mergeRefine role, /root/reference/src/utgcns/libcns/
    # abAbacus-refine.C): a surplus base in a homopolymer can be deleted
    # at ANY column of the run, so per-alignment ambiguity spreads the
    # del votes thin and no single column reaches the majority gate.
    # Stacking every run's del votes on its first column makes the
    # plurality see them as one event.
    iota = jnp.arange(n_rows, dtype=jnp.int32)[None, :]
    new_run = jnp.concatenate(
        [jnp.ones((B, 1), bool), t_sub[:, 1:n_rows] != t_sub[:, : n_rows - 1]],
        axis=1,
    )
    s_del = jnp.cumsum(m_del.astype(jnp.int32), axis=1)
    nxt = jnp.flip(jax.lax.associative_scan(
        jnp.minimum, jnp.flip(jnp.where(new_run, iota, n_rows), axis=1), axis=1
    ), axis=1)
    nxt_excl = jnp.concatenate(
        [nxt[:, 1:], jnp.full((B, 1), n_rows, jnp.int32)], axis=1)
    run_total = (
        jnp.take_along_axis(s_del, jnp.clip(nxt_excl - 1, 0, n_rows - 1), axis=1)
        - jnp.concatenate([jnp.zeros((B, 1), jnp.int32), s_del[:, :-1]], axis=1)
    )
    del_cnt = jnp.where(new_run, jnp.clip(run_total, 0, 15), 0)

    # pack each position's vote into one uint16, shift THAT to template
    # coordinates (one log-round pass instead of fifteen), then expand to
    # the channel one-hots at full width.  Deletions carry a 4-bit COUNT
    # (bits 10-13) at the run-start column instead of a per-column flag.
    code = (
        bchr.astype(jnp.uint16)
        | (ichr.astype(jnp.uint16) << 2)
        | (m_base.astype(jnp.uint16) << 4)
        | (m_ins.astype(jnp.uint16) << 6)
        | (m_ins2.astype(jnp.uint16) << 7)
        | (i2chr.astype(jnp.uint16) << 8)
        | (del_cnt.astype(jnp.uint16) << 10)
    )
    code = _shift_rows_right(code, t_bgn, Lt)  # [B, Lt]
    cb = code & 3
    ci = (code >> 2) & 3
    has_b = (code >> 4) & 1
    has_i = (code >> 6) & 1
    has_i2 = (code >> 7) & 1
    ci2 = (code >> 8) & 3
    d_cnt = (code >> 10) & 15
    chans = [(has_b == 1) & (cb == c) for c in range(4)]
    chans.append(d_cnt)  # CH_DEL carries counts, not a flag
    chans.append(has_i == 1)
    chans += [(has_i == 1) & (ci == c) for c in range(4)]
    chans.append(has_i2 == 1)
    chans += [(has_i2 == 1) & (ci2 == c) for c in range(4)]
    contrib = jnp.stack(
        [c.astype(jnp.bfloat16) for c in chans], axis=1
    )  # [B, 15, Lt]
    contrib = contrib.reshape(B, N_CH * Lt)
    # weight scales this job's whole contribution (evidence-quality
    # tie-break; ~1-phred granularity survives the bfloat16 cast)
    onehot = (slot[:, None] == jnp.arange(G, dtype=jnp.int32)[None, :]).astype(
        jnp.bfloat16
    ) * weight[:, None].astype(jnp.bfloat16)
    delta = jnp.einsum(
        "bg,bn->gn", onehot, contrib, preferred_element_type=jnp.float32
    )
    return votes + delta.reshape(G, N_CH, Lt)


@partial(jax.jit, static_argnames=("band", "n_rows", "Lt", "G", "ends_free"),
         donate_argnums=(0,))
def _vote_many(
    votes: jax.Array,  # f32[G, 15, Lt] accumulator (donated)
    t_words: jax.Array, t_lengths: jax.Array,
    e_words: jax.Array, e_lengths: jax.Array,
    packed_cols: jax.Array,  # int32[9, B]: job columns, weight bitcast
    band: int, n_rows: int, Lt: int, G: int,
    ends_free: bool = False,
) -> jax.Array:
    """One chunk of evidence jobs per dispatch (dispatches are async, so
    the host loop does not wait on the device between chunks)."""
    xs = packed_cols
    flipped = xs[6] != 0
    slot = xs[7]
    weight = jax.lax.bitcast_convert_type(xs[8], jnp.float32)
    return _vote_chunk_core(
        votes, t_words, t_lengths, e_words, e_lengths,
        xs[0], xs[1], xs[2], xs[3], xs[4], xs[5], flipped, slot, weight,
        band=band, n_rows=n_rows, Lt=Lt, G=G, ends_free=ends_free,
    )


def _template_codes(t_words, t_lengths, t_idx, Lt: int):
    t_all = unpack_bases(t_words[t_idx])
    LW = t_all.shape[1]
    if LW < Lt:
        t_all = jnp.pad(t_all, ((0, 0), (0, Lt - LW)))
    t_codes = t_all[:, :Lt]
    tl = t_lengths[t_idx]
    pos_live = jnp.arange(Lt, dtype=jnp.int32)[None, :] < tl[:, None]
    return t_codes, pos_live


@partial(jax.jit, static_argnames=("Lt", "keep_template"))
def _finalize_plurality(
    t_words, t_lengths, t_idx, votes, min_cov, Lt: int, keep_template: bool
):
    """Per-column plurality -> ONE packed uint8 per template column.

    The template does NOT vote for itself: in polish the backbone is a
    mosaic of the evidence reads, so a self-vote double-counts the
    originating read and a 2-vs-1 deletion majority fails by exactly
    one vote (observed: un-removable surplus homopolymer bases at 3x
    columns); in correction sub-min_cov columns are dropped anyway.
    Deletes/inserts need a strict majority of coverage.
    """
    t_codes, pos_live = _template_codes(t_words, t_lengths, t_idx, Lt)
    bv = votes[:, CH_BASE : CH_BASE + 4, :]  # [G, 4, Lt]
    cov = jnp.sum(bv, axis=1) + votes[:, CH_DEL, :]
    call = jnp.argmax(bv, axis=1).astype(jnp.uint8)
    delete = votes[:, CH_DEL, :] * 2 > cov
    insert_before = votes[:, CH_INS, :] * 2 > jnp.maximum(cov, 1.0)
    ins_call = jnp.argmax(votes[:, CH_INSBASE : CH_INSBASE + 4, :], axis=1
                          ).astype(jnp.uint16)
    insert2 = insert_before & (
        votes[:, CH_INS2, :] * 2 > jnp.maximum(cov, 1.0)
    )
    ins2_call = jnp.argmax(votes[:, CH_INS2BASE : CH_INS2BASE + 4, :], axis=1
                           ).astype(jnp.uint16)
    supported = (cov >= min_cov) & pos_live
    if keep_template:
        call = jnp.where(supported, call, t_codes)
        delete = delete & supported
        insert_before = insert_before & supported
        insert2 = insert2 & supported
        supported = pos_live
    packed = (
        call.astype(jnp.uint16)
        | (ins_call << PB_INS_CALL)
        | (supported.astype(jnp.uint16) << PB_SUPPORTED)
        | (delete.astype(jnp.uint16) << PB_DELETE)
        | (insert_before.astype(jnp.uint16) << PB_INSERT)
        | (insert2.astype(jnp.uint16) << PB_INSERT2)
        | (ins2_call << PB_INS2_CALL)
    )
    return packed, cov


@partial(jax.jit, static_argnames=("Lt",))
def _finalize_red(t_words, t_lengths, t_idx, votes, min_alt, max_own, Lt: int):
    """findErrors decision: alt base + fix flag per column, packed uint8.

    A position is corrected when an alternative base gets >= min_alt
    votes while the read's own base keeps <= max_own and no stronger
    deletion vote vetoes it (findErrors.C Vote_Qualify semantics)."""
    t_codes, pos_live = _template_codes(t_words, t_lengths, t_idx, Lt)
    bv = votes[:, CH_BASE : CH_BASE + 4, :]  # [G, 4, Lt]
    alt = jnp.argmax(bv, axis=1).astype(jnp.uint8)
    alt_v = jnp.max(bv, axis=1)
    own_v = jnp.take_along_axis(bv, t_codes[:, None, :].astype(jnp.int32),
                                axis=1)[:, 0, :]
    fix = (
        (alt != t_codes)
        & (alt_v >= min_alt)
        & (own_v <= max_own)
        & (votes[:, CH_DEL, :] < alt_v)
        & pos_live
    )
    return alt | (fix.astype(jnp.uint8) << 2)


# ---- host-side drivers -------------------------------------------------------


@dataclass
class VoteJobs:
    """Columnar evidence jobs (all int32/bool numpy arrays, same length).

    t_idx/e_idx index rows of the device word planes; t_bgn/t_span is the
    template window; e_lo/e_span the evidence window in ORIENTED
    coordinates (for flipped evidence, e_lo = len - fwd_end); slot is the
    template's row in the block accumulator."""

    t_idx: np.ndarray
    e_idx: np.ndarray
    t_bgn: np.ndarray
    t_span: np.ndarray
    e_lo: np.ndarray
    e_span: np.ndarray
    flipped: np.ndarray
    slot: np.ndarray
    # optional per-job vote weight (evidence quality tie-break); None = 1.0
    weight: np.ndarray | None = None

    def __len__(self):
        return len(self.t_idx)

    def weights(self) -> np.ndarray:
        if self.weight is None:
            return np.ones(len(self), np.float32)
        return self.weight

    @classmethod
    def concat(cls, parts):
        out = cls(**{
            f: np.concatenate([getattr(p, f) for p in parts])
            for f in ("t_idx", "e_idx", "t_bgn", "t_span", "e_lo", "e_span",
                      "flipped", "slot")
        })
        if any(p.weight is not None for p in parts):
            out.weight = np.concatenate([p.weights() for p in parts])
        return out


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


# budget knobs: positions per vote block (G*Lt) and DP cells per chunk
# (B*n_rows); sized so peak device memory stays < ~1 GB per shape
BLOCK_POS_BUDGET = 1 << 21
CHUNK_CELL_BUDGET = 1 << 21


def block_geometry(max_t_len: int) -> tuple[int, int]:
    """(G, Lt) for a template block whose longest template is max_t_len."""
    Lt = _pow2_at_least(max(max_t_len, 256))
    G = max(8, min(256, BLOCK_POS_BUDGET // Lt))
    return G, Lt


_COL_FIELDS = ("t_idx", "e_idx", "t_bgn", "t_span", "e_lo", "e_span",
               "flipped", "slot", "weight")


def pile_votes(
    t_words, t_lengths, e_words, e_lengths,
    jobs: VoteJobs, G: int, Lt: int, band: int | None = None,
    ends_free: bool = False,
) -> jax.Array:
    """Run all evidence jobs of one template block; returns device votes
    f32[G, 15, Lt].  Jobs are stacked into [C, B] column planes and
    dispatched one chunk at a time.

    Every job in a block runs at n_rows = Lt: ONE compiled shape per block
    geometry, even though short-span jobs waste DP rows (whether one more
    length bucket pays on the H100 is not measured)."""
    votes = jnp.zeros((G, N_CH, Lt), jnp.float32)
    n = len(jobs)
    if n == 0:
        return votes
    if jobs.weight is None:
        jobs.weight = np.ones(n, np.float32)
    n_rows = Lt
    B = max(32, min(256, CHUNK_CELL_BUDGET // n_rows))
    band_c = min(band if band is not None else 256, 256)
    C_total = -(-n // B)
    pad_n = C_total * B - n
    # one int32[C, 9, B] plane: int cols verbatim, bool as 0/1, float
    # weight bit-cast — a single h2d transfer per dispatch.  Pad jobs
    # have t_span=0 and weight=0: they align garbage (masked) and
    # contribute zero votes.
    packed = np.zeros((C_total, 9, B), np.int32)
    for fi, f in enumerate(_COL_FIELDS):
        v = getattr(jobs, f)
        if f == "weight":
            v = v.astype(np.float32).view(np.int32)
        else:
            v = v.astype(np.int32)
        if pad_n:
            v = np.concatenate([v, np.zeros(pad_n, np.int32)])
        packed[:, fi, :] = v.reshape(C_total, B)
    # dispatches are async, so the host loop races ahead and the device
    # queue stays full
    for c0 in range(C_total):
        votes = _vote_many(
            votes, t_words, t_lengths, e_words, e_lengths,
            jnp.asarray(packed[c0]), band_c, n_rows, Lt, G, ends_free,
        )
    return votes


def decode_pieces(row: np.ndarray):
    """Packed uint16 row -> list of (start_pos, piece_codes) over supported
    runs (falcon-sense low-coverage splitting)."""
    supported = (row >> PB_SUPPORTED) & 1
    call = row & 3
    delete = ((row >> PB_DELETE) & 1).astype(bool)
    ins = ((row >> PB_INSERT) & 1).astype(bool)
    ins_call = (row >> PB_INS_CALL) & 3
    ins2 = ((row >> PB_INSERT2) & 1).astype(bool) & ins
    ins2_call = (row >> PB_INS2_CALL) & 3
    padded = np.concatenate([[0], supported, [0]])
    starts = np.flatnonzero((padded[:-1] == 0) & (padded[1:] == 1))
    ends = np.flatnonzero((padded[:-1] == 1) & (padded[1:] == 0))
    out = []
    for b, e in zip(starts, ends):
        idx = np.arange(b, e)
        seq = _interleave2(
            call[idx].astype(np.uint8), ~delete[idx],
            ins[idx], ins_call[idx].astype(np.uint8),
            ins2[idx], ins2_call[idx].astype(np.uint8),
        )
        out.append((int(b), seq))
    return out


def _interleave2(bases, keep, ins, ins_call, ins2, ins2_call) -> np.ndarray:
    """Emit [ins1?][ins2?][base?] per position, vectorized (the evidence
    order: inserted chars precede the matched base)."""
    contrib = ins.astype(np.int64) + ins2.astype(np.int64) + keep.astype(np.int64)
    off = np.zeros(len(bases) + 1, np.int64)
    np.cumsum(contrib, out=off[1:])
    out = np.empty(int(off[-1]), np.uint8)
    ii = np.flatnonzero(ins)
    out[off[ii]] = ins_call[ii]
    jj = np.flatnonzero(ins2)
    out[off[jj] + 1] = ins2_call[jj]
    kk = np.flatnonzero(keep)
    out[off[kk] + ins[kk] + ins2[kk]] = bases[kk]
    return out


def segment_codes_plane(seg_codes, S: int):
    """Device plane for host code segments (<= S bases each): packed
    words [R(pow2 >= 1024), S/16] + lengths + pad row index.

    Shares the canonical shape family of falcon._segment_plane, so
    consensus polish and correction hit the SAME compiled vote program.
    """
    from ..utils.bitpack import BASES_PER_WORD, pack_codes

    SW = S // BASES_PER_WORD
    n = len(seg_codes)
    R = max(1024, 1 << max(0, int(n).bit_length()))  # always > n
    plane = np.zeros((R, SW), np.uint32)
    lens = np.zeros(R, np.int32)
    for i, c in enumerate(seg_codes):
        if len(c):
            w = pack_codes(np.asarray(c, np.uint8))
            plane[i, : len(w)] = w
        lens[i] = len(c)
    return jnp.asarray(plane), jnp.asarray(lens), R - 1


def device_words(rs) -> tuple[jax.Array, jax.Array]:
    """Device-resident packed words + lengths for a ReadSet; trailing
    all-zero padding rows (cached per ReadSet).

    BOTH dimensions are padded to powers of two: array shapes are jit
    cache keys, so canonical pow2 planes make every run with a
    similar-sized read set hit the same compiled vote programs and
    persistent-cache entries.  (The overlap-stage
    ReadIndex planes are NOT reused here for the same reason: their row
    count is exact.)"""
    cached = rs.__dict__.get("_device_words_cache")
    if cached is not None:
        try:  # OOM recovery deletes live arrays; stale entries rebuild
            if not cached[0].is_deleted():
                return cached
        except Exception:
            pass
    from ..utils.bitpack import n_words

    N = rs.n_reads
    max_len = int(rs.length.max()) if N else 1
    W = 1 << max(0, int(n_words(max_len) - 1).bit_length())
    # > N so pad rows exist; floor 128 keeps tiny stores (e.g. polish
    # segment planes of small contigs) on one canonical shape
    R = max(128, 1 << max(0, int(N).bit_length()))
    host_words, host_len = rs.block_words(np.arange(1, N + 1, dtype=np.int64), W)
    host_words = np.vstack(
        [host_words, np.zeros((R + 1 - N, W), np.uint32)]
    )
    host_len = np.concatenate([host_len, np.zeros(R + 1 - N, np.int32)])
    cached = (jnp.asarray(host_words), jnp.asarray(host_len))
    rs.__dict__["_device_words_cache"] = cached
    return cached
