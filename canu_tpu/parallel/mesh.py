"""Multi-chip sharding of the overlap pipeline (jax.sharding / shard_map).

Replaces the reference's grid-array distribution — the hash-block x
query-block MHAP job matrix (/root/reference/src/pipelines/canu/
OverlapMhap.pm:191-296) plus shared-filesystem shuffle — with a device
mesh and XLA collectives (SURVEY.md §2.13):

  * axis 'r' (data parallel): reads are sharded across devices, every
    device sketches its own read block;
  * axis 'h' (index/model parallel): the H min-hash slots are sharded by
    hash range, each device computing its slice of every local read's
    sketch — the "sketch index sharded by hash range" of BASELINE.json;
  * collectives: all_gather over 'h' assembles full sketches; all_gather
    over 'r' replaces the filesystem all-vs-all; candidate counts psum
    over nothing (they stay sharded by 'r').

The same step compiles on a virtual CPU mesh (tests, driver dryrun) and
on several GPUs of one host.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8 moved shard_map out of experimental
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..ops.hashing import mix32
from ..ops.kmer import INVALID_KMER, extract_kmers_any

UINT32_MAX = np.uint32(0xFFFFFFFF)


def make_overlap_mesh(n_devices: int | None = None) -> Mesh:
    """2D mesh ('r' reads-DP x 'h' hash-range) over the first n devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    assert len(devs) >= n, f"need {n} devices, have {len(devs)}"
    h = 2 if n % 2 == 0 and n >= 2 else 1
    r = n // h
    mesh_devs = np.array(devs[:n]).reshape(r, h)
    return Mesh(mesh_devs, ("r", "h"))


def _local_sketch(words, lengths, seeds, fk, k: int):
    """Sketch one read block against a slice of hash seeds. [B, H_loc]."""
    canon, _ = extract_kmers_any(words, lengths, k)
    valid = canon != INVALID_KMER
    if fk.shape[0] > 0:
        idx = jax.vmap(lambda v: jnp.searchsorted(fk, v))(canon)
        idx = jnp.minimum(idx, fk.shape[0] - 1)
        valid = valid & (fk[idx] != canon)
    H = seeds.shape[0]

    def body(h, acc):
        hv = mix32(canon ^ seeds[h])
        hv = jnp.where(valid, hv, UINT32_MAX)
        return acc.at[:, h].set(jnp.min(hv, axis=1))

    init = jnp.full((canon.shape[0], H), UINT32_MAX, jnp.uint32)
    return jax.lax.fori_loop(0, H, body, init)


def _count_matches(SA, SB, min_matches: int):
    """Slot-agreement counts [Na, Nb] -> candidate mask sums per row."""
    H = SA.shape[1]

    def body(h, acc):
        a = SA[:, h]
        b = SB[:, h]
        eq = (a[:, None] == b[None, :]) & (a != UINT32_MAX)[:, None]
        return acc + eq.astype(jnp.int32)

    cnt = jax.lax.fori_loop(0, H, body, jnp.zeros((SA.shape[0], SB.shape[0]), jnp.int32))
    return cnt


def sharded_overlap_step(mesh: Mesh, k: int = 16, min_matches: int = 3):
    """Build the jittable sharded sketch+match step.

    Returns step(words [N, W] u32, lengths [N] i32, seeds [H] u32,
    fk [F] u32) -> counts int32[N, N] (sharded over rows): per-pair
    sketch-slot agreement, the candidate-generation "forward pass".
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("r", None), P("r"), P("h"), P()),
        out_specs=P("r", None),
        check_vma=False,
    )
    def step(words, lengths, seeds_local, fk):
        sk_h = _local_sketch(words, lengths, seeds_local, fk, k)  # [B_loc, H_loc]
        sk = jax.lax.all_gather(sk_h, "h", axis=1, tiled=True)  # [B_loc, H]
        sk_all = jax.lax.all_gather(sk, "r", axis=0, tiled=True)  # [N, H]
        cnt = _count_matches(sk, sk_all, min_matches)  # [B_loc, N]
        return cnt

    return jax.jit(step)


def make_shard_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh ('s') for shuffle-style stages (k-mer count, store sort)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("s",))


def sharded_kmer_count_step(mesh: Mesh, k: int = 16, bin_capacity: int = 0):
    """Distributed k-mer counting by hash range (the multi-host meryl).

    Every device extracts its local reads' canonical k-mers, routes each
    to its owner shard (mix32(kmer) mod n) with ONE all_to_all — the
    collective replacing the reference's disk shuffle (ovStore-style
    bucketize/sort, SURVEY §2.13(3)) — then counts its hash range with a
    local sort.  Because all copies of a k-mer land on one shard, local
    counts are GLOBAL counts; the count histogram is psum-merged.

    step(words [N, W] u32, lengths [N] i32) ->
      (kmers u32[n*cap] per shard (INVALID-padded), counts i32[n*cap],
       hist i32[65] replicated, n_dropped i32 replicated)
    bin_capacity: per-destination send slots; k-mers beyond it are
    dropped and counted in n_dropped (size for ~2x the expected
    kmers/n_shards).  0 = auto from shapes.
    """
    from ..ops.kmer import histogram_device, sort_count

    n = mesh.devices.size

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("s", None), P("s")),
        out_specs=(P("s", None), P("s", None), P(), P()),
        check_vma=False,
    )
    def step(words, lengths):
        canon, _ = extract_kmers_any(words, lengths, k)
        km = canon.reshape(-1)
        valid = km != INVALID_KMER
        cap = bin_capacity or max(128, (2 * km.shape[0]) // n)
        owner = jnp.where(valid, mix32(km) % jnp.uint32(n), jnp.uint32(n))
        owner_s, km_s = jax.lax.sort((owner, km), dimension=0, num_keys=1)
        # rank of each element within its owner bin
        start = jnp.searchsorted(owner_s, jnp.arange(n + 1, dtype=jnp.uint32))
        idx = jnp.arange(km.shape[0], dtype=jnp.int32)
        own_i = jnp.minimum(owner_s, n).astype(jnp.int32)
        rank = idx - start[own_i].astype(jnp.int32)
        keep = (owner_s < n) & (rank < cap)
        n_dropped = jnp.sum((owner_s < n) & (rank >= cap), dtype=jnp.int32)
        send = jnp.full((n, cap), INVALID_KMER, jnp.uint32)
        # non-kept entries are routed to row n == out of bounds -> dropped
        send = send.at[
            jnp.where(keep, own_i, n), jnp.where(keep, rank, 0)
        ].set(km_s, mode="drop")
        recv = jax.lax.all_to_all(send, "s", split_axis=0, concat_axis=0,
                                  tiled=True)
        mine, counts = sort_count(recv.reshape(-1))
        hist = histogram_device(
            jnp.where(mine != INVALID_KMER, counts, 0), 64
        )
        hist = jax.lax.psum(hist, "s")
        n_dropped = jax.lax.psum(n_dropped, "s")
        return mine[None, :], counts[None, :].astype(jnp.int32), hist, n_dropped

    return jax.jit(step)


def sharded_kmer_count_step2(mesh: Mesh, k: int = 22, bin_capacity: int = 0):
    """Distributed EXACT 2-lane k-mer counting for 16 < k <= 32.

    Same hash-range all_to_all shuffle as sharded_kmer_count_step, but a
    k-mer is TWO uint32 lanes (ops.kmer.extract_kmers2); the owner shard
    is fold2(hi, lo) mod n and both lanes travel in one stacked
    all_to_all.  The obt/utg phases default to k=22
    (/root/reference/src/pipelines/canu/Defaults.pm ovlMerSize), so the
    multi-host meryl must cover the 2-lane path too.

    step(words, lengths) -> (hi u32[n*cap], lo u32[n*cap],
      counts i32[n*cap], hist i32[65] replicated, n_dropped replicated)
    """
    from ..ops.kmer import extract_kmers2, fold2, histogram_device, sort_count2

    n = mesh.devices.size

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("s", None), P("s")),
        out_specs=(P("s", None), P("s", None), P("s", None), P(), P()),
        check_vma=False,
    )
    def step(words, lengths):
        hi, lo, _strand, valid = extract_kmers2(words, lengths, k)
        v = valid.reshape(-1)
        hi = jnp.where(v, hi.reshape(-1), INVALID_KMER)
        lo = jnp.where(v, lo.reshape(-1), INVALID_KMER)
        cap = bin_capacity or max(128, (2 * hi.shape[0]) // n)
        owner = jnp.where(v, fold2(hi, lo) % jnp.uint32(n), jnp.uint32(n))
        owner_s, hi_s, lo_s = jax.lax.sort((owner, hi, lo), dimension=0,
                                           num_keys=1)
        start = jnp.searchsorted(owner_s, jnp.arange(n + 1, dtype=jnp.uint32))
        idx = jnp.arange(hi.shape[0], dtype=jnp.int32)
        own_i = jnp.minimum(owner_s, n).astype(jnp.int32)
        rank = idx - start[own_i].astype(jnp.int32)
        keep = (owner_s < n) & (rank < cap)
        n_dropped = jnp.sum((owner_s < n) & (rank >= cap), dtype=jnp.int32)
        send = jnp.full((n, 2, cap), INVALID_KMER, jnp.uint32)
        dst = jnp.where(keep, own_i, n)
        rnk = jnp.where(keep, rank, 0)
        send = send.at[dst, 0, rnk].set(hi_s, mode="drop")
        send = send.at[dst, 1, rnk].set(lo_s, mode="drop")
        recv = jax.lax.all_to_all(send, "s", split_axis=0, concat_axis=0,
                                  tiled=True)
        mh, ml, counts = sort_count2(
            recv[:, 0, :].reshape(-1), recv[:, 1, :].reshape(-1)
        )
        hist = histogram_device(
            jnp.where((mh != INVALID_KMER) | (ml != INVALID_KMER), counts, 0),
            64,
        )
        hist = jax.lax.psum(hist, "s")
        n_dropped = jax.lax.psum(n_dropped, "s")
        return (mh[None, :], ml[None, :], counts[None, :].astype(jnp.int32),
                hist, n_dropped)

    return jax.jit(step)
