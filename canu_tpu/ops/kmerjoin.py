"""Shared-k-mer join between read pairs via one variadic sort.

Finding the k-mers shared by two reads was originally a per-row
jnp.searchsorted (binary search = 13 serial gather rounds per
[512, 8192] call).  Instead: concatenate both reads' (kmer, payload)
arrays, ONE jax.lax.sort carrying payloads, and detect cross-read
matches as equal-key ADJACENT entries.  Payloads ride along in the
variadic sort, so no argsort-then-gather either.

Duplicate k-mers within a read only match once per adjacency — after
frequent-mer filtering duplicates are rare, and downstream median/vote
logic is robust to the loss.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .kmer import INVALID_KMER

TAG_B = 1


def pair_matches(canonA, validA, strandA, posA, canonB, validB, strandB, posB):
    """Cross-read equal-kmer matches for a batch of pairs.

    All inputs [C, P].  Returns masked match arrays of width 2P-1:
      hit bool, mposA, mposB int32, magree bool (strand flags equal).
    """
    C, P = canonA.shape
    keyA = jnp.where(validA, canonA, INVALID_KMER)
    keyB = jnp.where(validB, canonB, INVALID_KMER)
    keys = jnp.concatenate([keyA, keyB], axis=1)
    # payload: pos (<=2^29) | strand << 30 | tag << 31 -- int32 safe via
    # keeping the tag in a separate operand instead
    pay_pos = jnp.concatenate([posA, posB], axis=1).astype(jnp.int32)
    pay_meta = jnp.concatenate(
        [strandA.astype(jnp.int32), strandB.astype(jnp.int32) | 2], axis=1
    )
    ks, pos_s, meta_s = jax.lax.sort(
        (keys, pay_pos, pay_meta), dimension=1, num_keys=1
    )
    eq = (ks[:, 1:] == ks[:, :-1]) & (ks[:, :-1] != INVALID_KMER)
    tag_l = (meta_s[:, :-1] & 2) != 0
    tag_r = (meta_s[:, 1:] & 2) != 0
    hit = eq & (tag_l != tag_r)
    # the A-side entry is whichever neighbor has tag 0
    a_is_left = ~tag_l
    mposA = jnp.where(a_is_left, pos_s[:, :-1], pos_s[:, 1:])
    mposB = jnp.where(a_is_left, pos_s[:, 1:], pos_s[:, :-1])
    strA = jnp.where(a_is_left, meta_s[:, :-1], meta_s[:, 1:]) & 1
    strB = jnp.where(a_is_left, meta_s[:, 1:], meta_s[:, :-1]) & 1
    magree = strA == strB
    return hit, mposA, mposB, magree


def masked_median(values, mask, big=2**30):
    """Per-row median of masked int values via one sort. [C, W] -> [C]."""
    srt = jnp.sort(jnp.where(mask, values, big), axis=1)
    n = jnp.sum(mask.astype(jnp.int32), axis=1)
    idx = jnp.maximum(n - 1, 0) // 2
    return jnp.take_along_axis(srt, idx[:, None], axis=1)[:, 0]
