"""Per-read syncmer seed index: the device-resident seed store for
overlap verification.

Why this exists.  The verifier originally re-extracted EVERY k-mer of
both reads per candidate pair and joined them with width-2P variadic
sorts (P = padded positions, 8192 for 8 kb reads) — O(pair * P log^2 P)
run time, and XLA programs so large that each shape took many minutes
to compile.  The reference's overlapInCore has the
same structural idea as the fix: build a seed index over the read set
ONCE, then stream pairs against it
(/root/reference/src/overlapInCore/overlapInCore.C:191-300 builds a
hash table per hash block; minimap2's minimizer index is the modern
form).  On the device that becomes:

  * ONE pass over the read set extracts canonical k-mers and selects
    OPEN SYNCMERS — a k-mer is selected iff the minimal canonical
    s-mer hash inside it sits at the middle offset t=(k-s)/2.  Unlike
    window minimizers, selection depends only on the k-mer's OWN
    content, so a k-mer shared between two noisy reads is selected in
    BOTH or NEITHER (co-selection = 1; window minimizers co-select at
    only ~1/(2w) under 10 %-error reads because the competing
    neighbor hashes differ between the reads — measured as a 0.7 -> 0.46
    recall collapse).  Density 1/(k-s+1), s = k-4 -> ~1/5.
    Computed as one windowed shift-min sweep + compare: pure
    elementwise ops, no gathers.
  * selected (kmer, pos, strand) triples are compacted per read to a
    fixed width Pm = P/4 by one variadic sort;
  * the whole index lives ON DEVICE ([N, Pm] planes), so the verifier
    gathers rows by read id — per-chunk host->device traffic drops from
    megabytes of packed bases to kilobytes of ids.

Selection is strand-symmetric: s-mer hashes are of CANONICAL s-mers and
the offset t is the middle, which maps to itself under reverse
complement — a read and its rc select the same k-mer instances.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..stores.readset import ReadSet
from ..utils.bitpack import n_words
from .hashing import mix32
from .kmer import INVALID_KMER, extract_kmers, extract_kmers_any, length_bucketed_blocks

# numpy, NOT jnp: a module-level jnp scalar is a live device buffer that
# OOM recovery (utils.runtime.recover_device_memory) would delete, after
# which every retrace embedding it fails with 'Array has been deleted'
UINT32_MAX = np.uint32(0xFFFFFFFF)
# k-mer window over s-mers: s = k - SYNC_DELTA, density 1/(SYNC_DELTA+1).
# SYNC_DELTA must be even so the middle offset is strand-symmetric.
SYNC_DELTA = 4


def syncmer_params(k: int) -> tuple[int, int]:
    """(s, t): s-mer size and middle offset for open-syncmer selection.

    s must fit one uint32 lane (<= 16) and k - s must be even so the
    middle offset maps to itself under reverse complement."""
    if k <= 16 + SYNC_DELTA:
        s = k - SYNC_DELTA
    else:
        s = 16 if (k % 2 == 0) else 15
    return s, (k - s) // 2


def _shift_left(x: jax.Array, s: int, fill) -> jax.Array:
    """x[:, p+s] with `fill` entering on the right."""
    pad = jnp.full((x.shape[0], s), fill, x.dtype)
    return jnp.concatenate([x[:, s:], pad], axis=1)


def _window_min_fwd(x: jax.Array, w: int) -> jax.Array:
    """m[p] = min(x[p .. p+w-1]) (truncated at the right edge)."""
    cov, m = 1, x
    while cov < w:
        s = min(cov, w - cov)
        m = jnp.minimum(m, _shift_left(m, s, UINT32_MAX))
        cov += s
    return m


@partial(jax.jit, static_argnames=("k", "pm"))
def _syncmer_kernel(words, lengths, k: int, pm: int):
    """Select + compact open syncmers for one padded read block.

    words uint32[B, W], lengths int32[B].  Returns
    (mker uint32[B, pm], mpos int32[B, pm], mstr int32[B, pm],
     n_sel int32[B]); empty slots have mker == INVALID_KMER.
    """
    s, t = syncmer_params(k)
    assert s >= 2, "k too small for syncmer selection"
    canon, strand = extract_kmers_any(words, lengths, k)  # [B, Pk]
    valid = canon != INVALID_KMER
    Pk = canon.shape[1]

    scanon, _ = extract_kmers(words, lengths, s)  # [B, Ps], Ps = Pk + (k-s)
    hs = jnp.where(scanon != INVALID_KMER, mix32(scanon), UINT32_MAX)
    wm = _window_min_fwd(hs, k - s + 1)  # min s-hash inside k-mer at p
    hs_t = _shift_left(hs, t, UINT32_MAX) if t else hs
    sel = (hs_t[:, :Pk] == wm[:, :Pk]) & valid

    key = jnp.where(sel, mix32(canon), UINT32_MAX)
    pos = jnp.broadcast_to(
        jnp.arange(Pk, dtype=jnp.int32)[None, :], canon.shape
    )
    _, canon_s, pos_s, str_s = jax.lax.sort(
        (key, canon, pos, strand.astype(jnp.int32)), dimension=1, num_keys=1
    )
    n_sel = jnp.sum(sel.astype(jnp.int32), axis=1)
    # a short block can have fewer k-mer positions than the index width
    # (Pk < pm): pad the compacted planes out to pm with empties
    take = min(pm, Pk)
    canon_s = canon_s[:, :take]
    pos_s = pos_s[:, :take]
    str_s = str_s[:, :take]
    if take < pm:
        padw = ((0, 0), (0, pm - take))
        canon_s = jnp.pad(canon_s, padw, constant_values=INVALID_KMER)
        pos_s = jnp.pad(pos_s, padw, constant_values=-1)
        str_s = jnp.pad(str_s, padw, constant_values=0)
    col = jnp.arange(pm, dtype=jnp.int32)[None, :]
    live = col < n_sel[:, None]
    return (
        jnp.where(live, canon_s, INVALID_KMER),
        jnp.where(live, pos_s, -1),
        jnp.where(live, str_s, 0),
        jnp.minimum(n_sel, pm),
    )


@dataclass
class ReadIndex:
    """Device-resident packed reads + syncmer seeds (verify-path index).

    Row i holds read id i+1; a trailing all-zero row serves as the
    padding target for short chunks.  All arrays are jax device arrays:
      words  uint32[Npad, W]   2-bit packed bases
      length int32[Npad]
      mker   uint32[Npad, Pm]  canonical syncmer k-mers (INVALID pad)
      mpos   int32[Npad, Pm]   positions (forward-read coords)
      mstr   int32[Npad, Pm]   1 where the rc form was canonical
    """

    words: jax.Array
    length: jax.Array
    mker: jax.Array
    mpos: jax.Array
    mstr: jax.Array
    n_reads: int
    k: int
    pm: int

    @property
    def n_rows(self) -> int:
        return self.words.shape[0]


def build_read_index(
    readset: ReadSet,
    k: int = 16,
    pm: int | None = None,
    block_size: int = 128,
) -> ReadIndex:
    """Build the device index for a read set (one pass, ~O(N P log P)).

    pm defaults to P/4 (syncmer density 1/(SYNC_DELTA+1) = 1/5), capped
    at 2048 so per-pair join sorts stay narrow.
    """
    N = readset.n_reads
    max_len = int(readset.length.max()) if N else 1
    W = 1 << max(0, int(n_words(max_len) - 1).bit_length())
    if pm is None:
        pm = int(max(128, min(2048, 4 * W)))

    # packed words for the whole read set, one upload
    ids_all = np.arange(1, N + 1, dtype=np.int64)
    host_words, host_len = readset.block_words(ids_all, W)
    host_words = np.vstack([host_words, np.zeros((1, W), np.uint32)])
    host_len = np.concatenate([host_len, np.zeros(1, np.int32)])
    words_d = jnp.asarray(host_words)
    len_d = jnp.asarray(host_len)

    # syncmers per length-bucketed block, concatenated on device and
    # un-permuted with one device gather (no per-block host roundtrip)
    blocks_k, blocks_p, blocks_s = [], [], []
    order: list[np.ndarray] = []
    for ids, Wb in length_bucketed_blocks(readset, block_size):
        wb, lb = readset.block_words(ids, Wb)
        if len(ids) < block_size:
            padn = block_size - len(ids)
            wb = np.vstack([wb, np.zeros((padn, Wb), np.uint32)])
            lb = np.concatenate([lb, np.zeros(padn, np.int32)])
        mk, mp, ms, _ = _syncmer_kernel(jnp.asarray(wb), jnp.asarray(lb), k, pm)
        blocks_k.append(mk)
        blocks_p.append(mp)
        blocks_s.append(ms)
        padded_ids = np.concatenate(
            [ids, np.zeros(block_size - len(ids), np.int64)]
        ) if len(ids) < block_size else np.asarray(ids, dtype=np.int64)
        order.append(padded_ids)
    if blocks_k:
        cat_k = jnp.concatenate(blocks_k)
        cat_p = jnp.concatenate(blocks_p)
        cat_s = jnp.concatenate(blocks_s)
        rows = np.concatenate(order)  # rows[j] = read id at cat row j (0=pad)
        # perm[i] = cat row holding read id i+1; final pad row -> a pad row
        perm = np.zeros(N + 1, np.int64)
        live = rows > 0
        perm[rows[live] - 1] = np.flatnonzero(live)
        pad_rows = np.flatnonzero(~live)
        have_pad = len(pad_rows) > 0
        if have_pad:
            perm[N] = pad_rows[0]
        perm_d = jnp.asarray(perm, dtype=jnp.int32)
        mker = cat_k[perm_d]
        mpos = cat_p[perm_d]
        mstr = cat_s[perm_d]
        if not have_pad:  # force the trailing pad row empty
            is_last = jnp.arange(N + 1, dtype=jnp.int32)[:, None] == N
            mker = jnp.where(is_last, INVALID_KMER, mker)
            mpos = jnp.where(is_last, -1, mpos)
            mstr = jnp.where(is_last, 0, mstr)
    else:
        mker = jnp.full((1, pm), INVALID_KMER, jnp.uint32)
        mpos = jnp.full((1, pm), -1, jnp.int32)
        mstr = jnp.zeros((1, pm), jnp.int32)

    return ReadIndex(
        words=words_d, length=len_d, mker=mker, mpos=mpos, mstr=mstr,
        n_reads=N, k=k, pm=pm,
    )


def corrected_read_index(base: ReadIndex, readset: ReadSet) -> ReadIndex:
    """Index for a SUBSTITUTION-corrected copy of base's read set.

    OEA's corrected reads differ from the originals only by in-place
    substitutions (ops.oea.apply_corrections), so read lengths and
    syncmer geometry are unchanged; only the packed word plane needs
    re-uploading.  The seed k-mer VALUES at corrected positions go
    stale, but seeds only vote orientation and center the band — a few
    stale anchors among hundreds are harmless, while re-extracting
    syncmers for the whole set would redo the index build.
    """
    W = base.words.shape[1]
    ids_all = np.arange(1, readset.n_reads + 1, dtype=np.int64)
    host_words, _ = readset.block_words(ids_all, W)
    host_words = np.vstack([host_words, np.zeros((1, W), np.uint32)])
    return ReadIndex(
        words=jnp.asarray(host_words), length=base.length, mker=base.mker,
        mpos=base.mpos, mstr=base.mstr, n_reads=base.n_reads, k=base.k,
        pm=base.pm,
    )


def get_read_index(readset: ReadSet, k: int) -> ReadIndex:
    """Cached index per (readset, k) — ReadSets are immutable.

    A cache hit re-validates the device buffers: OOM recovery
    (utils.runtime.recover_device_memory) deletes every live array
    between stage retries, so a stale entry would poison the retry with
    'Array has been deleted' errors.  Deleted entries rebuild."""
    cache = readset.__dict__.setdefault("_read_index_cache", {})
    idx = cache.get(k)
    if idx is not None:
        try:
            if idx.words.is_deleted():
                idx = None
        except Exception:
            idx = None
    if idx is None:
        idx = build_read_index(readset, k=k)
        cache[k] = idx
    return idx
