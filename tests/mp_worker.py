"""Worker for the 2-process jax.distributed test (test_multiprocess).

Each process joins the cluster, feeds ONLY ITS OWN host shard of reads
into the sharded meryl / ring-candidate stages, and process 0 checks
the results against the single-device reference implementations.
Run: python tests/mp_worker.py <pid> <nprocs> <port>
(env must set JAX_PLATFORMS=cpu, XLA_FLAGS=--xla_force_host_platform_device_count=N.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid = int(sys.argv[1])
n_proc = int(sys.argv[2])
port = sys.argv[3]

from canu_tpu.parallel.launch import init_distributed

p, n = init_distributed(f"127.0.0.1:{port}", n_proc, pid)
import jax

assert n == n_proc and jax.process_count() == n_proc, (p, n)
print(f"[{pid}] joined: {jax.device_count()} global devices", flush=True)

import numpy as np

from canu_tpu.ops import kmer as K
from canu_tpu.ops import minhash as MH
from canu_tpu.parallel.shard_overlap import (
    sharded_count_readset,
    sharded_find_candidates,
)
from canu_tpu.sim.simulate import random_genome, simulate_reads

g = random_genome(30_000, seed=7)
rs, _ = simulate_reads(g, coverage=6, mean_len=2500, min_len=1500,
                       max_len=4000, error_rate=0.05, seed=8, circular=False)

for k in (16, 22):
    kc_sh = sharded_count_readset(rs, k=k)
    ref = K.count_readset_device(rs, k=k, block_size=256).to_host()
    order = np.argsort(ref.unique, kind="stable")
    ref_u, ref_c = ref.unique[order], ref.counts[order]
    if pid == 0:
        assert len(kc_sh.unique) == len(ref_u), (k, len(kc_sh.unique), len(ref_u))
        assert np.array_equal(np.asarray(kc_sh.unique, dtype=ref_u.dtype), ref_u), k
        assert np.array_equal(kc_sh.counts, ref_c), k
        print(f"[0] meryl k={k}: {len(ref_u)} distinct EQUAL", flush=True)

fk = K.frequent_kmers(K.count_readset_device(rs, k=16, block_size=256),
                      distinct_fraction=0.9995)
sk = np.asarray(MH.build_sketches(rs, k=16, n_hashes=128, frequent=fk,
                                  block_size=256))
cand_sh = sharded_find_candidates(sk, min_matches=2)
cand_ref = MH.find_candidates(sk, min_matches=2, block_size=256)
if pid == 0:
    a = {(int(r[0]), int(r[1])) for r in cand_sh}
    b = {(int(r[0]), int(r[1])) for r in np.asarray(cand_ref)}
    assert a == b, (len(a), len(b), list(a ^ b)[:5])
    print(f"[0] ring candidates: {len(a)} pairs EQUAL", flush=True)
    print("MP_TEST_OK", flush=True)

# process-sharded full-featured verification: each process verifies its
# strided slice, the allgathered table must equal the single-process one
from canu_tpu.parallel.shard_overlap import process_sharded_verify
from canu_tpu.ops import align as AL

tab_sh = process_sharded_verify(rs, np.asarray(cand_sh), k=16, chunk=64)
tab_ref = AL.verify_overlaps(rs, np.asarray(cand_sh), k=16, chunk=64)
if pid == 0:
    def rows(t):
        return {
            (int(a), int(b), bool(f), int(ab), int(ae), int(bb), int(be), int(e))
            for a, b, f, ab, ae, bb, be, e in zip(
                t.a_id, t.b_id, t.flipped, t.a_bgn, t.a_end,
                t.b_bgn, t.b_end, t.erate_q,
            )
        }
    ra, rb = rows(tab_sh), rows(tab_ref)
    assert ra == rb, (len(ra), len(rb), list(ra ^ rb)[:4])
    print(f"[0] process-sharded verify: {len(ra)} overlaps EQUAL", flush=True)

print("MP_TEST_OK2", flush=True)

# a_id-range exchange store build: per-process sorted shards merged by
# the writer must hold EXACTLY the rows of the single-process
# OverlapStore.build, and no process may hold the full table
from canu_tpu.parallel.shard_overlap import (
    process_sharded_store_rows,
    table_to_sym_rows,
)
from canu_tpu.stores.overlaps import OverlapStore

mine = process_sharded_store_rows(rs, np.asarray(cand_sh), k=16, chunk=64)
total_rows = 2 * len(tab_ref)
assert len(mine) < total_rows, (len(mine), total_rows)  # memory bound held
np.save(f"shard{pid:04d}.WORKING.npy", mine)
os.replace(f"shard{pid:04d}.WORKING.npy", f"shard{pid:04d}.npy")
from canu_tpu.parallel.launch import barrier

barrier("mp-shards")
if pid == 0:
    shards = sorted(
        f for f in os.listdir(".") if f.startswith("shard") and f.endswith(".npy")
    )
    OverlapStore.save_from_row_shards(shards, rs.n_reads, "mp.ovlStore")
    st_sh = OverlapStore.load("mp.ovlStore")
    st_ref = OverlapStore.build(tab_ref, rs.n_reads)
    assert len(st_sh) == len(st_ref), (len(st_sh), len(st_ref))
    # same multiset of rows; index identical (a_id-major order on both)
    def row_set(st):
        return {
            tuple(int(getattr(st, c)[i]) for c in
                  ("a_id", "b_id", "flipped", "a_bgn", "a_end",
                   "b_bgn", "b_end", "erate_q"))
            for i in range(len(st))
        }
    assert row_set(st_sh) == row_set(st_ref)
    assert np.array_equal(st_sh.index, st_ref.index)
    # shards are globally sorted by a_id when concatenated in order
    assert (np.diff(st_sh.a_id) >= 0).all()
    print(f"[0] range-exchange store: {len(st_sh)} rows EQUAL", flush=True)
print("MP_TEST_OK3", flush=True)
