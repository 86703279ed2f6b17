"""MinHash sketch overlap candidate detection (MHAP equivalent).

Replaces the reference's vendored MHAP jar (MinHash sketch + ordered
sketch second stage, invoked from
/root/reference/src/pipelines/canu/OverlapMhap.pm:318-550) with a fully
on-device design — no JVM, no text files:

  stage A  sketch: per read, H independent min-hash slots over its
           canonical k-mers, with frequent k-mers dropped (the ignore
           file + tf-idf down-weighting contract of
           OverlapMhap.pm:382-396 / Meryl.pm:648-720);
  stage B  match: block x block slot-agreement counting on the VPU (the
           all-vs-all job matrix of OverlapMhap.pm:191-296 becomes a
           device loop over block pairs);
  stage C  placement: for surviving pairs, shared-k-mer sort-merge gives
           an orientation vote and a median diagonal + inlier span
           (the role of MHAP's ordered-sketch second stage).

Outputs a host candidate table (a_id, b_id, flipped, diag, spans,
n_shared) for the banded verifier (canu_tpu.ops.align).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..stores.readset import ReadSet
from ..utils.bitpack import n_words
from .hashing import hash_seeds, mix32
from .kmer import INVALID_KMER, FrequentKmers, extract_kmers_any, length_bucketed_blocks

UINT32_MAX = np.uint32(0xFFFFFFFF)


def _fk_array(frequent: "FrequentKmers | None") -> np.ndarray:
    """Frequent-kmer array, never empty: zero-sized device buffers trip an
    XLA buffer-count bug; INVALID_KMER (0xFFFFFFFF) can never equal a
    canonical k-mer, so a 1-sentinel array is a no-op filter."""
    if frequent is not None and frequent.n:
        return frequent.kmers
    return np.full(1, 0xFFFFFFFF, np.uint32)


# ---- stage A: sketches ------------------------------------------------------


@partial(jax.jit, static_argnames=("k",))
def _sketch_kernel(words, lengths, seeds, fk_kmers, k: int):
    """Sketches for one padded read block.

    words uint32[B, W], lengths int32[B], seeds uint32[H],
    fk_kmers uint32[F] sorted frequent k-mers (F may be 0).
    Returns uint32[B, H] min-hash values (UINT32_MAX for empty reads).
    """
    canon, _ = extract_kmers_any(words, lengths, k)  # [B, P]
    valid = canon != INVALID_KMER
    if fk_kmers.shape[0] > 0:
        idx = jax.vmap(lambda v: jnp.searchsorted(fk_kmers, v))(canon)
        idx = jnp.minimum(idx, fk_kmers.shape[0] - 1)
        frequent = fk_kmers[idx] == canon
        valid = valid & ~frequent
    H = seeds.shape[0]
    B = canon.shape[0]

    def body(h, acc):
        hv = mix32(canon ^ seeds[h])
        hv = jnp.where(valid, hv, UINT32_MAX)
        return acc.at[:, h].set(jnp.min(hv, axis=1))

    init = jnp.full((B, H), UINT32_MAX, jnp.uint32)
    return jax.lax.fori_loop(0, H, body, init)


def build_sketches(
    readset: ReadSet,
    k: int = 16,
    n_hashes: int = 128,
    frequent: Optional[FrequentKmers] = None,
    block_size: int = 256,
    seed: int = 0xA5EED,
) -> np.ndarray:
    """Sketch every read; returns uint32[N, H] (host), rows = read_id-1."""
    seeds = jnp.asarray(hash_seeds(n_hashes, seed))
    fk = jnp.asarray(_fk_array(frequent))
    out = np.full((readset.n_reads, n_hashes), 0xFFFFFFFF, dtype=np.uint32)
    # dispatch every block before fetching any (one round-trip per block,
    # not one sync per block — the device pipelines the whole pass)
    pending = []
    for ids, W in length_bucketed_blocks(readset, block_size):
        words, lengths = readset.block_words(ids, W)
        if len(ids) < block_size:
            pad = block_size - len(ids)
            words = np.vstack([words, np.zeros((pad, W), np.uint32)])
            lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
        sk = _sketch_kernel(jnp.asarray(words), jnp.asarray(lengths), seeds, fk, k)
        pending.append((ids, sk))
    for ids, sk in pending:
        out[ids - 1] = np.asarray(sk)[: len(ids)]
    return out


# ---- stage B: block x block slot matching -----------------------------------


@partial(jax.jit, static_argnames=("min_matches", "self_block", "max_out"))
def _match_kernel(SA, SB, min_matches: int, self_block: bool, max_out: int):
    """Count agreeing sketch slots for every (i, j) in a block pair.

    SA uint32[Na, H], SB uint32[Nb, H].  Returns (ii, jj, cnt, n_found)
    fixed-size (max_out) candidate lists; for a self block only i < j is
    reported.  UINT32_MAX slots (empty reads) never match.
    """
    H = SA.shape[1]

    def body(h, acc):
        a = SA[:, h]
        b = SB[:, h]
        eq = (a[:, None] == b[None, :]) & (a != UINT32_MAX)[:, None]
        return acc + eq.astype(jnp.int32)

    cnt = jax.lax.fori_loop(0, H, body, jnp.zeros((SA.shape[0], SB.shape[0]), jnp.int32))
    mask = cnt >= min_matches
    if self_block:
        ii = jax.lax.broadcasted_iota(jnp.int32, mask.shape, 0)
        jj = jax.lax.broadcasted_iota(jnp.int32, mask.shape, 1)
        mask = mask & (ii < jj)
    n_found = jnp.sum(mask.astype(jnp.int32))
    ii, jj = jnp.nonzero(mask, size=max_out, fill_value=SA.shape[0])
    safe_i = jnp.minimum(ii, SA.shape[0] - 1)
    safe_j = jnp.minimum(jj, SB.shape[0] - 1)
    c = jnp.where(ii < SA.shape[0], cnt[safe_i, safe_j], 0)
    return ii, jj, c, n_found


def find_candidates(
    sketches: np.ndarray,
    min_matches: int = 3,
    block_size: int = 1024,
    max_out_per_blockpair: int = 1 << 17,
) -> np.ndarray:
    """All-vs-all candidate pairs from sketches.

    Returns int64[M, 3] (a_id, b_id, slot_matches) with a_id < b_id
    (1-based).  The reference's hash-block x query-block job matrix
    (OverlapMhap.pm:214-296) becomes a host loop over device block pairs.
    """
    N = len(sketches)
    S = jnp.asarray(sketches)
    rows: list[np.ndarray] = []
    starts = list(range(0, N, block_size))
    # dispatch EVERY block pair before fetching any result: the device
    # queues the whole job matrix and the host pays one round-trip per
    # pair instead of a sync each (the n_found fetch serialized the loop)
    pending = []
    for bi, sa in enumerate(starts):
        ea = min(sa + block_size, N)
        SA = S[sa:ea]
        for sb in starts[bi:]:
            eb = min(sb + block_size, N)
            SB = S[sb:eb]
            out = _match_kernel(
                SA, SB, min_matches, sa == sb, max_out_per_blockpair
            )
            pending.append((sa, sb, out))
    # batched drain: ONE fetch for every pair's n_found, then grouped
    # fetches of the candidate columns sliced to each group's max count
    # — instead of a scalar sync + 3 array fetches per pair
    nf_all = np.asarray(jnp.stack([out[3] for _, _, out in pending])) \
        if pending else np.zeros(0, np.int64)
    if len(nf_all) and int(nf_all.max()) > max_out_per_blockpair:
        bad = int(np.argmax(nf_all))
        raise RuntimeError(
            f"candidate overflow in block pair "
            f"({pending[bad][0]},{pending[bad][1]}): {int(nf_all[bad])}; "
            f"raise max_out_per_blockpair or min_matches"
        )
    GROUP = 8
    for g0 in range(0, len(pending), GROUP):
        grp = pending[g0 : g0 + GROUP]
        nfs = nf_all[g0 : g0 + GROUP]
        nfmax = int(nfs.max(initial=0))
        if nfmax == 0:
            continue
        packed = np.asarray(jnp.stack([
            jnp.stack([out[0][:nfmax], out[1][:nfmax], out[2][:nfmax]])
            for _, _, out in grp
        ]))  # [K, 3, nfmax] — one d2h per group
        for k, (sa, sb, _out) in enumerate(grp):
            nf = int(nfs[k])
            if nf == 0:
                continue
            ii = packed[k, 0, :nf].astype(np.int64) + sa + 1
            jj = packed[k, 1, :nf].astype(np.int64) + sb + 1
            cc = packed[k, 2, :nf].astype(np.int64)
            rows.append(np.stack([ii, jj, cc], axis=1))
    if not rows:
        return np.zeros((0, 3), dtype=np.int64)
    out = np.concatenate(rows)
    # cross-block pairs can appear with a_id > b_id never (sb >= sa and
    # self-block filtered) — but normalize anyway for safety.
    flip = out[:, 0] > out[:, 1]
    out[flip, 0], out[flip, 1] = out[flip, 1], out[flip, 0]
    return out[np.lexsort((out[:, 1], out[:, 0]))]


def find_candidates_join(
    sketches: np.ndarray,
    min_matches: int = 3,
    slot_chunk: int = 64,
    bucket_cap: int = 2048,
) -> np.ndarray:
    """All-vs-all candidates via an LSH hash-JOIN — O(N·H) sort instead
    of the O(N²) block×block compare.  Pair-set IDENTICAL to
    find_candidates: a pair matches in slot h iff sketches[i,h] ==
    sketches[j,h] != UINT32_MAX, and pairs with >= min_matches agreeing
    slots are kept.  This is what the reference's MHAP actually does
    (min-hash values bucket reads; only bucket-mates are compared) and
    the only path that scales to the 140 Mb-genome read count, where
    the block matrix is ~10^6 block pairs.

    Buckets larger than bucket_cap reads (one hash value shared by that
    many reads — a repeat family the frequent-mer filter missed) are
    dropped with a warning; MHAP's tf-idf down-weighting plays the same
    role (/root/reference/src/pipelines/canu/OverlapMhap.pm:382-396).
    """
    import logging

    N, H = sketches.shape
    if N < 2:
        return np.zeros((0, 3), dtype=np.int64)
    counts: dict = {}
    dropped = 0
    # process slot groups to bound peak memory at N*slot_chunk keys
    pair_chunks: list[np.ndarray] = []
    for h0 in range(0, H, slot_chunk):
        h1 = min(h0 + slot_chunk, H)
        sub = sketches[:, h0:h1]
        hc = h1 - h0
        vals = sub.T.reshape(-1).astype(np.int64)  # slot-major [hc*N]
        slots = np.repeat(np.arange(h0, h1, dtype=np.int64), N)
        reads = np.tile(np.arange(N, dtype=np.int64), hc)
        keys = (slots << np.int64(32)) | vals
        keep = vals != int(UINT32_MAX)
        keys, reads = keys[keep], reads[keep]
        order = np.argsort(keys, kind="stable")
        keys, reads = keys[order], reads[order]
        # bucket boundaries
        new = np.concatenate([[True], keys[1:] != keys[:-1]])
        starts = np.flatnonzero(new)
        ends = np.concatenate([starts[1:], [len(keys)]])
        sizes = ends - starts
        big = sizes > bucket_cap
        dropped += int(big.sum())
        keepb = ~big & (sizes > 1)
        # vectorized pair expansion grouped by bucket SIZE: all buckets
        # of size s expand through one [B_s, s] gather + triu — no
        # per-bucket python loop (there are millions of tiny buckets at
        # the 140 Mb scale)
        for s in np.unique(sizes[keepb]):
            sel = starts[keepb & (sizes == s)]
            members = reads[sel[:, None] + np.arange(s)[None, :]]
            members = np.sort(members, axis=1)
            li, lj = np.triu_indices(int(s), 1)
            pair_chunks.append(np.stack(
                [members[:, li].reshape(-1), members[:, lj].reshape(-1)],
                axis=1))
    if dropped:
        logging.getLogger("canu_tpu.minhash").warning(
            "hash-join: dropped %d buckets larger than %d reads "
            "(unfiltered repeat hash values)", dropped, bucket_cap)
    if not pair_chunks:
        return np.zeros((0, 3), dtype=np.int64)
    pairs = np.concatenate(pair_chunks)
    key = pairs[:, 0] * np.int64(N + 1) + pairs[:, 1]
    uniq, cnt = np.unique(key, return_counts=True)
    keep = cnt >= min_matches
    uniq, cnt = uniq[keep], cnt[keep]
    out = np.empty((len(uniq), 3), np.int64)
    out[:, 0] = uniq // (N + 1) + 1  # 1-based ids, a < b by construction
    out[:, 1] = uniq % (N + 1) + 1
    out[:, 2] = cnt
    return out[np.lexsort((out[:, 1], out[:, 0]))]


# ---- stage C: shared-kmer placement ----------------------------------------


@partial(jax.jit, static_argnames=("k",))
def _pair_stats_kernel(wordsA, lenA, wordsB, lenB, seeds0, fk_kmers, k: int):
    """Per candidate pair: orientation vote + median diagonal + span.

    All arrays are [C, ...] (one row per pair).  Returns
    (flipped bool[C], diag int32[C], n_inliers int32[C],
     a_lo, a_hi, b_lo, b_hi int32[C]) where spans cover the inlier
    k-mer matches (B span in forward-B coordinates).

    Shared k-mers come from the one-sort adjacency join
    (canu_tpu.ops.kmerjoin) -- no per-row searchsorted.
    """
    from .kmerjoin import masked_median, pair_matches

    canonA, strandA = extract_kmers_any(wordsA, lenA, k)  # [C, P]
    canonB, strandB = extract_kmers_any(wordsB, lenB, k)
    P = canonA.shape[1]
    validA = canonA != INVALID_KMER
    validB = canonB != INVALID_KMER
    if fk_kmers.shape[0] > 0:
        idx = jax.vmap(lambda v: jnp.searchsorted(fk_kmers, v))(canonB)
        idx = jnp.minimum(idx, fk_kmers.shape[0] - 1)
        validB = validB & (fk_kmers[idx] != canonB)
    pos = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32)[None, :], canonA.shape)
    hit, posA_m, posB_m, agree = pair_matches(
        canonA, validA, strandA, pos, canonB, validB, strandB, pos
    )

    n_same = jnp.sum((hit & agree).astype(jnp.int32), axis=1)
    n_opp = jnp.sum((hit & ~agree).astype(jnp.int32), axis=1)
    flipped = n_opp > n_same

    # B position mapped into forward-A-compatible coordinates
    posB_fl = lenB[:, None] - k - posB_m  # position in rc(B)
    posB_eff = jnp.where(flipped[:, None], posB_fl, posB_m)
    sel = hit & (agree != flipped[:, None])  # matches agreeing with the vote
    diag = posA_m - posB_eff

    BIG = jnp.int32(2**30)
    med = masked_median(diag, sel)

    # inliers: diagonal within an indel-proportional tolerance
    min_len = jnp.minimum(lenA, lenB)
    tol = jnp.maximum(100, (min_len * 0.30).astype(jnp.int32))
    inl = sel & (jnp.abs(diag - med[:, None]) <= tol[:, None])
    n_inl = jnp.sum(inl.astype(jnp.int32), axis=1)

    # spans over inlier matches (A coords; B span in forward-B coords)
    a_lo = jnp.min(jnp.where(inl, posA_m, BIG), axis=1)
    a_hi = jnp.max(jnp.where(inl, posA_m + k, -1), axis=1)
    b_lo = jnp.min(jnp.where(inl, posB_m, BIG), axis=1)
    b_hi = jnp.max(jnp.where(inl, posB_m + k, -1), axis=1)
    med2 = masked_median(diag, inl)

    return flipped, med2, n_inl, a_lo, a_hi, b_lo, b_hi


@dataclass
class OverlapCandidates:
    """Placed overlap candidates awaiting alignment verification.

    diag = (position of B's start in A coordinates) after orienting B to
    match A (if flipped, coordinates refer to reverse-complemented B when
    aligning, but b_lo/b_hi stay in forward-B coordinates, matching the
    reference ovOverlap convention that hangs are strand-normalized —
    /root/reference/src/stores/ovOverlap.H:227-292).
    """

    a_id: np.ndarray  # int32, 1-based
    b_id: np.ndarray
    flipped: np.ndarray  # bool
    diag: np.ndarray  # int32
    n_shared: np.ndarray  # int32 inlier shared k-mers
    a_lo: np.ndarray
    a_hi: np.ndarray
    b_lo: np.ndarray
    b_hi: np.ndarray

    def __len__(self) -> int:
        return len(self.a_id)


def place_candidates(
    readset: ReadSet,
    pairs: np.ndarray,
    k: int = 16,
    frequent: Optional[FrequentKmers] = None,
    min_shared: int = 4,
    chunk: int = 256,
) -> OverlapCandidates:
    """Run stage C on candidate (a_id, b_id) pairs; filter by inlier count."""
    fk = jnp.asarray(_fk_array(frequent))
    seeds0 = jnp.zeros(1, jnp.uint32)  # reserved
    cols: dict[str, list[np.ndarray]] = {
        n: [] for n in ("a_id", "b_id", "flipped", "diag", "n_shared", "a_lo", "a_hi", "b_lo", "b_hi")
    }
    M = len(pairs)
    for s in range(0, M, chunk):
        chunk_pairs = pairs[s : s + chunk]
        a_ids = chunk_pairs[:, 0].astype(np.int64)
        b_ids = chunk_pairs[:, 1].astype(np.int64)
        wmax = n_words(
            int(max(readset.length[a_ids - 1].max(), readset.length[b_ids - 1].max()))
        )
        W = 1 << max(0, int(wmax - 1).bit_length())
        wa, la = readset.block_words(a_ids, W)
        wb, lb = readset.block_words(b_ids, W)
        C = len(chunk_pairs)
        if C < chunk:
            padw = np.zeros((chunk - C, W), np.uint32)
            padl = np.zeros(chunk - C, np.int32)
            wa, la = np.vstack([wa, padw]), np.concatenate([la, padl])
            wb, lb = np.vstack([wb, padw]), np.concatenate([lb, padl])
        fl, dg, ni, alo, ahi, blo, bhi = _pair_stats_kernel(
            jnp.asarray(wa), jnp.asarray(la), jnp.asarray(wb), jnp.asarray(lb), seeds0, fk, k
        )
        keep = np.asarray(ni[:C]) >= min_shared
        cols["a_id"].append(a_ids[keep].astype(np.int32))
        cols["b_id"].append(b_ids[keep].astype(np.int32))
        cols["flipped"].append(np.asarray(fl[:C])[keep])
        cols["diag"].append(np.asarray(dg[:C])[keep])
        cols["n_shared"].append(np.asarray(ni[:C])[keep])
        cols["a_lo"].append(np.asarray(alo[:C])[keep])
        cols["a_hi"].append(np.asarray(ahi[:C])[keep])
        cols["b_lo"].append(np.asarray(blo[:C])[keep])
        cols["b_hi"].append(np.asarray(bhi[:C])[keep])

    def cat(name, dtype):
        arrs = cols[name]
        return (
            np.concatenate(arrs).astype(dtype) if arrs else np.zeros(0, dtype)
        )

    return OverlapCandidates(
        a_id=cat("a_id", np.int32),
        b_id=cat("b_id", np.int32),
        flipped=cat("flipped", bool),
        diag=cat("diag", np.int32),
        n_shared=cat("n_shared", np.int32),
        a_lo=cat("a_lo", np.int32),
        a_hi=cat("a_hi", np.int32),
        b_lo=cat("b_lo", np.int32),
        b_hi=cat("b_hi", np.int32),
    )
