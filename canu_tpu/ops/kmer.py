"""Device k-mer extraction and counting (meryl equivalent).

Replaces the reference meryl k-mer counter
(/root/reference/src/meryl/meryl.C, libmeryl.C — pack mers, segment,
sort, merge) with a device design: packed read blocks unpack with
elementwise shifts/masks, canonical k-mers are computed with branch-free bit
twiddling, and counting is ONE device sort over the whole read set plus a
fixed-shape run-length reduction.  Only small results (count histogram,
frequent-mer table) leave the device — device-to-host bandwidth is the
scarce resource, not FLOPs.

k is limited to <= 16 so a canonical k-mer fits one uint32 lane (the
reference default for the MHAP stage is 16 —
/root/reference/src/pipelines/canu/Defaults.pm mhapMerSize; its ovl stage
uses 22, which we will support later via 2-lane packing).

Multi-chip scaling: k-mers are sharded by hash range (top bits of a mixed
hash) and exchanged via all_to_all before the per-shard sort; see
canu_tpu.parallel.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial
from typing import Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..stores.readset import ReadSet
from ..utils.bitpack import n_words

# Sentinel that sorts after every valid canonical k-mer (valid k-mers for
# k=16 use all 32 bits, but the canonical min(fw, rc) can never be
# 0xFFFFFFFF: its own revcomp would be 0x0 which is smaller).
INVALID_KMER = np.uint32(0xFFFFFFFF)


def unpack_bases(words: jax.Array) -> jax.Array:
    """uint32[..., W] packed words -> uint8[..., W*16] base codes (device).

    Inverse of canu_tpu.utils.bitpack.pack_codes, but on device.
    """
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, :]
    expanded = (words[..., :, None] >> shifts) & jnp.uint32(3)
    return expanded.reshape(*words.shape[:-1], words.shape[-1] * 16).astype(jnp.uint8)


def reverse_2bit_groups(x: jax.Array) -> jax.Array:
    """Reverse the sixteen 2-bit groups of each uint32 lane."""
    x = (x >> 16) | (x << 16)
    x = ((x & jnp.uint32(0xFF00FF00)) >> 8) | ((x & jnp.uint32(0x00FF00FF)) << 8)
    x = ((x & jnp.uint32(0xF0F0F0F0)) >> 4) | ((x & jnp.uint32(0x0F0F0F0F)) << 4)
    x = ((x & jnp.uint32(0xCCCCCCCC)) >> 2) | ((x & jnp.uint32(0x33333333)) << 2)
    return x


def revcomp_kmer(kmers: jax.Array, k: int) -> jax.Array:
    """Reverse complement of packed k-mers (first base most significant)."""
    mask = jnp.uint32(0xFFFFFFFF) if k == 16 else jnp.uint32((1 << (2 * k)) - 1)
    comp = (~kmers) & mask
    return reverse_2bit_groups(comp << jnp.uint32(32 - 2 * k))


@partial(jax.jit, static_argnames=("k",))
def extract_kmers(words: jax.Array, lengths: jax.Array, k: int):
    """Canonical k-mers of a padded read block.

    Args:
      words: uint32[B, W] packed reads (zero-padded).
      lengths: int32[B] read lengths in bases.
      k: k-mer size, 2..16.

    Returns:
      canon: uint32[B, P] canonical k-mers (INVALID_KMER where the window
        falls off the read), P = W*16 - k + 1.
      strand: bool[B, P] True where the reverse-complement was the
        canonical form (needed for overlap orientation voting).
    """
    assert 2 <= k <= 16
    bases = unpack_bases(words)  # [B, L]
    B, L = bases.shape
    P = L - k + 1
    # fw[i] = sum_j bases[i+j] << 2*(k-1-j): k shifted adds.
    fw = jnp.zeros((B, P), dtype=jnp.uint32)
    for j in range(k):
        fw = (fw << 2) | bases[:, j : j + P].astype(jnp.uint32)
    rc = revcomp_kmer(fw, k)
    canon = jnp.minimum(fw, rc)
    strand = rc < fw
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = pos <= (lengths[:, None] - k)
    canon = jnp.where(valid, canon, INVALID_KMER)
    return canon, strand


@partial(jax.jit, static_argnames=("k",))
def extract_kmers2(words: jax.Array, lengths: jax.Array, k: int):
    """Canonical k-mers for 16 < k <= 32 as TWO uint32 lanes.

    Returns (hi uint32[B, P], lo uint32[B, P], strand bool[B, P],
    valid bool[B, P]); the exact 2k-bit canonical k-mer is
    (hi << 32) | lo.  The reference meryl packs arbitrary k the same way
    into multiple machine words (/root/reference/src/meryl/libmeryl.C);
    two uint32 lanes keep every op on 32-bit words.
    """
    assert 16 < k <= 32
    bases = unpack_bases(words)  # [B, L]
    B, L = bases.shape
    P = L - k + 1
    hi = jnp.zeros((B, P), jnp.uint32)
    lo = jnp.zeros((B, P), jnp.uint32)
    for j in range(k):
        b = bases[:, j : j + P].astype(jnp.uint32)
        hi = (hi << 2) | (lo >> 30)
        lo = (lo << 2) | b
    hi = hi & jnp.uint32((1 << (2 * k - 32)) - 1)
    # reverse complement: complement, reverse all 64 bits (reverse each
    # lane's 2-bit groups and swap lanes), then right-align to 2k bits
    rh = reverse_2bit_groups(~lo)
    rl = reverse_2bit_groups(~hi)
    s = 64 - 2 * k  # 0 <= s < 32
    if s:
        rc_lo = (rl >> s) | (rh << (32 - s))
        rc_hi = rh >> s
    else:
        rc_lo, rc_hi = rl, rh
    rc_hi = rc_hi & jnp.uint32((1 << (2 * k - 32)) - 1)
    fw_first = (hi < rc_hi) | ((hi == rc_hi) & (lo <= rc_lo))
    c_hi = jnp.where(fw_first, hi, rc_hi)
    c_lo = jnp.where(fw_first, lo, rc_lo)
    strand = ~fw_first
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = pos <= (lengths[:, None] - k)
    return c_hi, c_lo, strand, valid


def fold2(hi: jax.Array, lo: jax.Array) -> jax.Array:
    """Universal 32-bit key of a 2-lane k-mer (well-dispersed mix)."""
    from .hashing import mix32

    return mix32(hi.astype(jnp.uint32) ^ mix32(lo))


def extract_kmers_any(words: jax.Array, lengths: jax.Array, k: int):
    """Canonical k-mer KEYS (uint32) + strand for any k in 2..32.

    k <= 16: exact packed canonical k-mers (extract_kmers).
    k > 16: a 32-bit universal hash of the exact canonical k-mer (2-lane
    packing folded with mix32).  Hash keys are exactly what the MATCHING
    path needs (MinHash slots, syncmer seeds and anchor joins are
    hash-based by construction; a per-pair false anchor costs ~P^2/2^32);
    exact counting for k > 16 lives in count_readset_device's 2-lane
    sort path.  INVALID_KMER marks off-read windows in both cases.
    """
    if k <= 16:
        return extract_kmers(words, lengths, k)
    hi, lo, strand, valid = extract_kmers2(words, lengths, k)
    key = fold2(hi, lo)
    key = jnp.where(key == INVALID_KMER, key ^ jnp.uint32(1), key)
    return jnp.where(valid, key, INVALID_KMER), strand


@jax.jit
def sort_count(kmers_flat: jax.Array):
    """Sort a flat uint32 k-mer array and run-length count it (fixed shape).

    Returns (sorted, counts) where counts[i] is the run length at run
    START positions and 0 elsewhere; INVALID_KMER entries sort to the end
    and get count 0 so they never pollute histograms/selection.
    """
    s = jnp.sort(kmers_flat)
    n = s.shape[0]
    is_start = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
    run_id = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    per_run = jax.ops.segment_sum(jnp.ones(n, jnp.int32), run_id, num_segments=n)
    counts = jnp.where(is_start & (s != INVALID_KMER), per_run[run_id], 0)
    return s, counts


@partial(jax.jit, static_argnames=("max_count",))
def histogram_device(counts: jax.Array, max_count: int = 65535) -> jax.Array:
    """hist[c] = number of runs with length exactly c (c clipped to
    max_count); hist[0] is meaningless (non-start positions).

    Device equivalent of meryl -Dh (/root/reference/src/meryl/meryl-dump.C).
    """
    return jnp.bincount(jnp.minimum(counts, max_count), length=max_count + 1)


@partial(jax.jit, static_argnames=("max_out",))
def select_frequent_device(sorted_kmers: jax.Array, counts: jax.Array, threshold, max_out: int):
    """Gather (kmer, count) pairs with count > threshold, fixed size.

    Returns (kmers[max_out], counts[max_out], n_found); unused slots hold
    INVALID_KMER / 0.  If n_found > max_out the table is truncated
    (caller should warn and raise max_out).
    """
    mask = counts > threshold
    idx = jnp.nonzero(mask, size=max_out, fill_value=sorted_kmers.shape[0])[0]
    safe = idx < sorted_kmers.shape[0]
    km = jnp.where(safe, sorted_kmers[jnp.minimum(idx, sorted_kmers.shape[0] - 1)], INVALID_KMER)
    ct = jnp.where(safe, counts[jnp.minimum(idx, sorted_kmers.shape[0] - 1)], 0)
    return km, ct, jnp.sum(mask.astype(jnp.int32))


# ---- block planning ---------------------------------------------------------


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def length_bucketed_blocks(readset: ReadSet, block_size: int) -> Iterator[tuple[np.ndarray, int]]:
    """Yield (ids, pad_words) blocks with reads sorted by descending
    length and pad_words rounded to a power of two, so at most
    O(log max_len) distinct device shapes are compiled while bounding
    padding waste to <2x.
    """
    order = np.argsort(-readset.length, kind="stable")
    ids = (order + 1).astype(np.int32)
    for i in range(0, len(ids), block_size):
        chunk = ids[i : i + block_size]
        wmax = n_words(int(readset.length[chunk - 1].max()))
        yield chunk, _pow2_at_least(max(1, wmax))


# ---- whole-readset counting -------------------------------------------------


class DeviceKmerCounts:
    """Sorted k-mers + run-length counts living on device.

    The hot pipeline consumes these without a host roundtrip: the
    histogram (small) drives threshold choice, and the frequent-mer table
    (small) feeds MinHash down-weighting.  ``to_host()`` materializes the
    full unique/count table for tools and tests.
    """

    def __init__(self, k: int, sorted_kmers: jax.Array, counts: jax.Array):
        self.k = k
        self.sorted_kmers = sorted_kmers
        self.counts = counts

    def histogram(self, max_count: int = 65535) -> np.ndarray:
        return np.asarray(histogram_device(self.counts, max_count))

    def n_distinct(self) -> int:
        return int(jnp.sum(self.counts > 0))

    def n_total(self) -> int:
        return int(jnp.sum(self.counts))

    def frequent(self, threshold: int, max_out: int = 1 << 20) -> "FrequentKmers":
        km, ct, n_found = select_frequent_device(
            self.sorted_kmers, self.counts, jnp.int32(threshold), max_out
        )
        n_found = int(n_found)
        if n_found > max_out:
            import warnings

            warnings.warn(
                f"frequent-kmer table truncated: {n_found} > max_out={max_out}"
            )
            n_found = max_out
        km = np.asarray(km[:n_found])
        ct = np.asarray(ct[:n_found])
        total = self.n_total()
        return FrequentKmers(
            k=self.k,
            kmers=km,
            fraction=(ct / max(1, total)).astype(np.float32),
            threshold=int(threshold),
            total_kmers=total,
        )

    def to_host(self) -> "KmerCounts":
        counts = np.asarray(self.counts)
        kmers = np.asarray(self.sorted_kmers)
        keep = counts > 0
        return KmerCounts(self.k, kmers[keep], counts[keep].astype(np.int64))


@jax.jit
def sort_count2(hi_flat: jax.Array, lo_flat: jax.Array):
    """2-lane (k > 16) sort + run-length count; INVALID_KMER in BOTH
    lanes marks padding (sorts last since hi is the primary key)."""
    hs, ls = jax.lax.sort((hi_flat, lo_flat), dimension=0, num_keys=2)
    n = hs.shape[0]
    is_start = jnp.concatenate(
        [jnp.ones(1, bool), (hs[1:] != hs[:-1]) | (ls[1:] != ls[:-1])]
    )
    run_id = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    per_run = jax.ops.segment_sum(jnp.ones(n, jnp.int32), run_id, num_segments=n)
    live = (hs != INVALID_KMER) | (ls != INVALID_KMER)
    counts = jnp.where(is_start & live, per_run[run_id], 0)
    return hs, ls, counts


class DeviceKmerCounts2:
    """2-lane (k > 16) device k-mer counts; API-compatible subset of
    DeviceKmerCounts.  Exact counting — only the matching path uses
    folded 32-bit keys."""

    def __init__(self, k: int, hi: jax.Array, lo: jax.Array, counts: jax.Array):
        self.k = k
        self.hi = hi
        self.lo = lo
        self.counts = counts

    def histogram(self, max_count: int = 65535) -> np.ndarray:
        return np.asarray(histogram_device(self.counts, max_count))

    def n_distinct(self) -> int:
        return int(jnp.sum(self.counts > 0))

    def n_total(self) -> int:
        return int(jnp.sum(self.counts))

    def frequent(self, threshold: int, max_out: int = 1 << 20) -> "FrequentKmers":
        mask = np.asarray(self.counts > threshold)
        hi = np.asarray(self.hi)[mask].astype(np.uint64)
        lo = np.asarray(self.lo)[mask].astype(np.uint64)
        ct = np.asarray(self.counts)[mask]
        exact = (hi << np.uint64(32)) | lo
        folded = np.asarray(fold2(jnp.asarray(hi.astype(np.uint32)),
                                  jnp.asarray(lo.astype(np.uint32))))
        folded = np.where(folded == INVALID_KMER, folded ^ np.uint32(1), folded)
        order = np.argsort(folded, kind="stable")
        total = self.n_total()
        return FrequentKmers(
            k=self.k,
            kmers=folded[order],
            fraction=(ct[order] / max(1, total)).astype(np.float32),
            threshold=int(threshold),
            total_kmers=total,
            kmers_exact=exact[order],
        )

    def to_host(self) -> "KmerCounts":
        counts = np.asarray(self.counts)
        keep = counts > 0
        hi = np.asarray(self.hi)[keep].astype(np.uint64)
        lo = np.asarray(self.lo)[keep].astype(np.uint64)
        return KmerCounts(self.k, (hi << np.uint64(32)) | lo,
                          counts[keep].astype(np.int64))


def count_readset_host(readset: ReadSet, k: int) -> "KmerCounts":
    """Host canonical k-mer counter (vectorized numpy) for inputs whose
    instance table exceeds the device budget.

    The device counter concatenates EVERY k-mer instance into one
    on-device sort; past ~130M 2-lane instances the sort temporaries
    exhaust a 16 GB device (12 Mb x 18x corrected reads OOM'd obt-meryl
    on every attempt).  The reference's meryl is a host counter too
    (/root/reference/src/meryl/meryl.C:69-126, segment by memory + sort
    per segment); here one numpy pass computes fwd/rc 64-bit k-mers with
    k shifted adds and np.unique sorts once, with zero device memory.
    """
    from ..utils import bitpack

    assert 1 < k <= 32
    words = np.asarray(readset.words)
    n = len(words) * bitpack.BASES_PER_WORD
    if n == 0 or readset.n_reads == 0:
        return KmerCounts(k, np.zeros(0, np.uint64 if k > 16 else np.uint32),
                          np.zeros(0, np.int64))
    allb = bitpack.unpack_words(words, n)
    base0 = (readset.word_off[:-1] * bitpack.BASES_PER_WORD).astype(np.int64)
    L = readset.length.astype(np.int64)
    # valid k-mer start positions: within a read, start + k <= read end
    delta = np.zeros(n + 1, np.int32)
    np.add.at(delta, base0, 1)
    np.add.at(delta, base0 + np.maximum(L - k + 1, 0), -1)
    vm = np.cumsum(delta[:-1]) > 0
    m = n - k + 1
    if m <= 0:
        return KmerCounts(k, np.zeros(0, np.uint64 if k > 16 else np.uint32),
                          np.zeros(0, np.int64))
    # k <= 16 fits 2k bits in uint32: half the memory and a ~2x faster
    # sort — at the 140 Mb-genome scale (4.2e9 instances) the uint64
    # path peaks ~100 GB and the uint32 path ~50 GB on this host
    dt = np.uint32 if k <= 16 else np.uint64
    fwd = np.zeros(m, dt)
    rc = np.zeros(m, dt)
    for j in range(k):
        bj = allb[j : j + m].astype(dt)
        fwd = (fwd << dt(2)) | bj
        rc |= (dt(3) - bj) << dt(2 * j)
    canon = np.minimum(fwd, rc)[vm[:m]]
    del fwd, rc
    u, c = np.unique(canon, return_counts=True)
    return KmerCounts(k, u, c.astype(np.int64))


def count_readset_device(
    readset: ReadSet, k: int = 16, block_size: int = 512,
    max_instances: int | None = None,
):
    """Count canonical k-mers of a whole ReadSet with one device sort.

    All per-block k-mer arrays are kept on device and concatenated
    (padded to a power-of-two total so the sort compiles O(1) times per
    process); nothing large crosses back to host.  k <= 16 counts one
    uint32 lane; 16 < k <= 32 counts exact 2-lane k-mers (the reference
    ovl/utg stages default to k=22, Defaults.pm ovlMerSize).

    Above ``max_instances`` total k-mer instances (default 2^27 one-lane
    / 2^26 two-lane, override CANU_TPU_KMER_MAX_INSTANCES) the device
    sort cannot fit HBM and the host counter takes over, returning a
    host KmerCounts — every downstream consumer (histogram, thresholds,
    frequent_kmers) accepts both.
    """
    two = k > 16
    if max_instances is None:
        import os as _os

        try:
            max_instances = int(_os.environ["CANU_TPU_KMER_MAX_INSTANCES"])
        except (KeyError, ValueError):
            max_instances = (1 << 26) if two else (1 << 27)
    est = int(readset.length.astype(np.int64).sum())
    if est > max_instances:
        return count_readset_host(readset, k)
    parts = []
    for ids, W in length_bucketed_blocks(readset, block_size):
        words, lengths = readset.block_words(ids, W)
        if len(ids) < block_size:  # pad rows so [B, W] shape is stable
            pad = block_size - len(ids)
            words = np.vstack([words, np.zeros((pad, W), np.uint32)])
            lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
        if two:
            hi, lo, _, valid = extract_kmers2(
                jnp.asarray(words), jnp.asarray(lengths), k
            )
            hi = jnp.where(valid, hi, INVALID_KMER)
            lo = jnp.where(valid, lo, INVALID_KMER)
            parts.append((hi.reshape(-1), lo.reshape(-1)))
        else:
            canon, _ = extract_kmers(jnp.asarray(words), jnp.asarray(lengths), k)
            parts.append(canon.reshape(-1))
    if two:
        if not parts:
            e = jnp.full((1,), INVALID_KMER, jnp.uint32)
            hs, ls, c = sort_count2(e, e)
            return DeviceKmerCounts2(k, hs, ls, c)
        hi = jnp.concatenate([p[0] for p in parts])
        lo = jnp.concatenate([p[1] for p in parts])
        n = hi.shape[0]
        n_pad = _pow2_at_least(n)
        if n_pad != n:
            fill = jnp.full((n_pad - n,), INVALID_KMER, jnp.uint32)
            hi = jnp.concatenate([hi, fill])
            lo = jnp.concatenate([lo, fill])
        hs, ls, c = sort_count2(hi, lo)
        return DeviceKmerCounts2(k, hs, ls, c)
    if not parts:
        empty = jnp.full((1,), INVALID_KMER, jnp.uint32)
        s, c = sort_count(empty)
        return DeviceKmerCounts(k, s, c)
    flat = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    n = flat.shape[0]
    n_pad = _pow2_at_least(n)
    if n_pad != n:
        flat = jnp.concatenate([flat, jnp.full((n_pad - n,), INVALID_KMER, jnp.uint32)])
    s, c = sort_count(flat)
    return DeviceKmerCounts(k, s, c)


@dataclass
class KmerCounts:
    """Host-side k-mer counts (sorted unique k-mers + counts)."""

    k: int
    unique: np.ndarray  # uint32, sorted
    counts: np.ndarray  # int64

    @property
    def n_distinct(self) -> int:
        return len(self.unique)

    @property
    def n_total(self) -> int:
        return int(self.counts.sum())

    def histogram(self, max_count: Optional[int] = None) -> np.ndarray:
        """hist[c] = number of distinct k-mers occurring exactly c times."""
        h = np.bincount(np.minimum(self.counts, max_count) if max_count else self.counts)
        return h

    def merge(self, other: "KmerCounts") -> "KmerCounts":
        assert self.k == other.k
        u = np.concatenate([self.unique, other.unique])
        c = np.concatenate([self.counts, other.counts])
        order = np.argsort(u, kind="stable")
        u, c = u[order], c[order]
        if len(u) == 0:
            return KmerCounts(self.k, u, c)
        starts = np.concatenate([[True], u[1:] != u[:-1]])
        idx = np.cumsum(starts) - 1
        out_c = np.zeros(int(starts.sum()), dtype=np.int64)
        np.add.at(out_c, idx, c)
        return KmerCounts(self.k, u[starts], out_c)

    # ---- database algebra (meryl binary/unary ops) -----------------------
    # Equivalents of the reference meryl's DB operations
    # (/root/reference/src/meryl/meryl-binaryOp.C, meryl-unaryOp.C and the
    # op table in meryl.C: add/sub/min/max/and/or/xor + count filters).

    def _aligned(self, other: "KmerCounts"):
        """Counts of both DBs over the union key set (0 where absent)."""
        assert self.k == other.k
        u = np.union1d(self.unique, other.unique)
        ca = np.zeros(len(u), np.int64)
        cb = np.zeros(len(u), np.int64)
        ca[np.searchsorted(u, self.unique)] = self.counts
        cb[np.searchsorted(u, other.unique)] = other.counts
        return u, ca, cb

    def _from_aligned(self, u: np.ndarray, c: np.ndarray) -> "KmerCounts":
        keep = c > 0
        return KmerCounts(self.k, u[keep], c[keep])

    def union_sum(self, other: "KmerCounts") -> "KmerCounts":
        """meryl add: union of keys, counts summed."""
        return self.merge(other)

    def union_min(self, other: "KmerCounts") -> "KmerCounts":
        """meryl or+min: union of keys, min of PRESENT counts."""
        u, ca, cb = self._aligned(other)
        both = (ca > 0) & (cb > 0)
        c = np.where(both, np.minimum(ca, cb), ca + cb)
        return self._from_aligned(u, c)

    def union_max(self, other: "KmerCounts") -> "KmerCounts":
        """meryl or+max: union of keys, max of counts."""
        u, ca, cb = self._aligned(other)
        return self._from_aligned(u, np.maximum(ca, cb))

    def intersect_min(self, other: "KmerCounts") -> "KmerCounts":
        """meryl and (min): keys in BOTH, min count."""
        u, ca, cb = self._aligned(other)
        c = np.where((ca > 0) & (cb > 0), np.minimum(ca, cb), 0)
        return self._from_aligned(u, c)

    def intersect_max(self, other: "KmerCounts") -> "KmerCounts":
        u, ca, cb = self._aligned(other)
        c = np.where((ca > 0) & (cb > 0), np.maximum(ca, cb), 0)
        return self._from_aligned(u, c)

    def intersect_sum(self, other: "KmerCounts") -> "KmerCounts":
        u, ca, cb = self._aligned(other)
        c = np.where((ca > 0) & (cb > 0), ca + cb, 0)
        return self._from_aligned(u, c)

    def subtract(self, other: "KmerCounts") -> "KmerCounts":
        """meryl sub: counts subtracted, clipped at 0 (keys vanish at 0)."""
        u, ca, cb = self._aligned(other)
        return self._from_aligned(u, np.maximum(ca - cb, 0))

    def difference(self, other: "KmerCounts") -> "KmerCounts":
        """meryl xor-ish difference: keys of self NOT in other."""
        u, ca, cb = self._aligned(other)
        return self._from_aligned(u, np.where(cb == 0, ca, 0))

    def at_least(self, threshold: int) -> "KmerCounts":
        """meryl -Dt style count filter: keep count >= threshold."""
        m = self.counts >= threshold
        return KmerCounts(self.k, self.unique[m], self.counts[m])

    def at_most(self, threshold: int) -> "KmerCounts":
        m = self.counts <= threshold
        return KmerCounts(self.k, self.unique[m], self.counts[m])

    # ---- persistence (meryl .mcidx/.mcdat database equivalent) ------------

    def save(self, path: str) -> None:
        """Persist the counted database (one compressed file; plays the
        role of the reference meryl's .mcidx/.mcdat DB pair written by
        /root/reference/src/meryl/libmeryl.C — counted once, reused by
        later stages and DB algebra)."""
        np.savez_compressed(
            path if str(path).endswith(".npz") else f"{path}.npz",
            k=np.int64(self.k), unique=self.unique, counts=self.counts,
        )

    @staticmethod
    def load(path: str) -> "KmerCounts":
        p = str(path)
        if not p.endswith(".npz") and os.path.exists(p + ".npz"):
            p = p + ".npz"
        with np.load(p) as z:
            return KmerCounts(
                int(z["k"]), z["unique"].astype(np.uint32),
                z["counts"].astype(np.int64),
            )


def count_reads(
    readset: ReadSet,
    k: int = 16,
    block_size: int = 512,
    pad_words: Optional[int] = None,  # unused, kept for API stability
) -> KmerCounts:
    """Count canonical k-mers and return the host table (tools/tests).

    The hot pipeline should use count_readset_device + DeviceKmerCounts
    instead to avoid the large device-to-host fetch.
    """
    return count_readset_device(readset, k, block_size).to_host()


# ---- thresholds / frequent-mer selection -----------------------------------


def _threshold_from_histogram(hist: np.ndarray, n_distinct: int, fraction: float) -> int:
    cum = np.cumsum(hist[1:])
    target = fraction * n_distinct
    c = int(np.searchsorted(cum, target)) + 1
    return max(1, c)


def threshold_from_distinct_fraction(kc, fraction: float) -> int:
    """Smallest count c such that k-mers with count <= c cover `fraction`
    of distinct k-mers.

    Mirrors the reference's `*MerDistinct` threshold semantics
    (/root/reference/src/pipelines/canu/Meryl.pm:585-611): the mhap ignore
    set is "every k-mer more frequent than the distinct-fraction cutoff".
    Accepts KmerCounts or DeviceKmerCounts.
    """
    if isinstance(kc, (DeviceKmerCounts, DeviceKmerCounts2)):
        hist = kc.histogram()
        nd = int(hist[1:].sum())
    else:
        if kc.n_distinct == 0:
            return 1
        hist = kc.histogram()
        nd = kc.n_distinct
    if nd == 0:
        return 1
    return _threshold_from_histogram(hist, nd, fraction)


def estimate_coverage_threshold(kc, multiplier: float = 4.0) -> int:
    """Valley/peak repeat threshold (estimate-mer-threshold equivalent).

    Finds the error-kmer valley in the count histogram, the coverage peak
    after it, and returns multiplier * peak as the repeat cutoff —
    same shape of logic as
    /root/reference/src/meryl/estimate-mer-threshold.C:43-67,284-290
    (which scans for the histogram break after guessing X coverage).
    """
    hist = (kc.histogram(100_000) if isinstance(kc, (DeviceKmerCounts, DeviceKmerCounts2)) else kc.histogram(max_count=100_000))
    if len(hist) < 4:
        return max(2, len(hist))
    h = hist[1:]  # h[i] = #distinct with count i+1
    valley = 0
    for i in range(1, len(h) - 1):
        if h[i] <= h[i - 1] and h[i] <= h[i + 1]:
            valley = i
            break
    peak = valley + int(np.argmax(h[valley:])) if valley < len(h) else valley
    thr = int(multiplier * (peak + 1))
    return max(2, thr)


@dataclass
class FrequentKmers:
    """Frequent k-mer table with tf fractions for MinHash down-weighting.

    Equivalent of the mhap ignore file written by the reference
    (/root/reference/src/pipelines/canu/Meryl.pm:648-720: k-mer +
    fraction-of-total columns, consumed by MHAP's tf-idf filter).
    """

    k: int
    kmers: np.ndarray  # uint32, sorted (k > 16: folded 32-bit keys)
    fraction: np.ndarray  # float32 — count / total k-mers
    threshold: int
    total_kmers: int
    # k > 16 only: the exact 2k-bit k-mers (uint64), aligned with kmers
    kmers_exact: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return len(self.kmers)


def frequent_kmers(kc, threshold: Optional[int] = None, distinct_fraction: float = 0.9995) -> FrequentKmers:
    """Frequent-mer table from KmerCounts or DeviceKmerCounts."""
    if threshold is None:
        threshold = threshold_from_distinct_fraction(kc, distinct_fraction)
    if isinstance(kc, (DeviceKmerCounts, DeviceKmerCounts2)):
        return kc.frequent(int(threshold))
    mask = kc.counts > threshold
    frac = (kc.counts[mask] / max(1, kc.n_total)).astype(np.float32)
    if kc.k > 16:
        exact = kc.unique[mask].astype(np.uint64)
        hi = (exact >> np.uint64(32)).astype(np.uint32)
        lo = exact.astype(np.uint32)
        folded = np.asarray(fold2(jnp.asarray(hi), jnp.asarray(lo)))
        folded = np.where(folded == INVALID_KMER, folded ^ np.uint32(1), folded)
        order = np.argsort(folded, kind="stable")
        return FrequentKmers(
            k=kc.k, kmers=folded[order], fraction=frac[order],
            threshold=int(threshold), total_kmers=kc.n_total,
            kmers_exact=exact[order],
        )
    return FrequentKmers(
        k=kc.k,
        kmers=kc.unique[mask],
        fraction=frac,
        threshold=int(threshold),
        total_kmers=kc.n_total,
    )


def union_frequent(a: FrequentKmers, b: FrequentKmers) -> FrequentKmers:
    """Union of two frequent-mer tables (same k): the reference's
    OvlFrequentMers mechanism — user-supplied mers excluded from seeding
    in ADDITION to the counted frequent set
    (/root/reference/src/pipelines/canu/Defaults.pm OvlFrequentMers).
    Duplicate keys keep the larger fraction."""
    assert a.k == b.k, (a.k, b.k)
    kmers = np.concatenate([a.kmers, b.kmers])
    frac = np.concatenate([a.fraction, b.fraction])
    exact = None
    if a.kmers_exact is not None or b.kmers_exact is not None:
        ea = a.kmers_exact if a.kmers_exact is not None else np.zeros(
            len(a.kmers), np.uint64)
        eb = b.kmers_exact if b.kmers_exact is not None else np.zeros(
            len(b.kmers), np.uint64)
        exact = np.concatenate([ea, eb])
    order = np.lexsort((-frac, kmers))
    kmers, frac = kmers[order], frac[order]
    if exact is not None:
        exact = exact[order]
    keep = np.concatenate([[True], kmers[1:] != kmers[:-1]])
    return FrequentKmers(
        k=a.k, kmers=kmers[keep], fraction=frac[keep],
        threshold=min(a.threshold, b.threshold),
        total_kmers=max(a.total_kmers, b.total_kmers),
        kmers_exact=exact[keep] if exact is not None else None,
    )


def frequent_from_fasta(path: str, k: int) -> FrequentKmers:
    """Frequent-mer table from a FASTA of sequences whose k-mers must
    never seed overlaps (reference OvlFrequentMers file format).  Every
    k-mer window of every record is excluded with fraction 1.0."""
    from ..io.fastx import read_fastx
    from ..stores.readset import ReadSet
    from ..utils.bitpack import seq_to_codes

    codes = [seq_to_codes(r.seq) for r in read_fastx(path)
             if len(r.seq) >= k]
    if not codes:
        return FrequentKmers(k=k, kmers=np.zeros(0, np.uint32),
                             fraction=np.zeros(0, np.float32),
                             threshold=0, total_kmers=0)
    rs = ReadSet.from_codes_list(codes, [f"m{i}" for i in range(len(codes))])
    kc = count_readset_host(rs, k)
    fk = frequent_kmers(kc, threshold=0)
    fk.fraction[:] = 1.0
    return fk
