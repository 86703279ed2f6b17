"""Config-5 scale demo worker: 2 jax.distributed CPU processes run the
sharded overlap path — sharded meryl, ring candidates, process-sharded
verify, a_id-RANGE store exchange, shard-merge store build — on a
genome-size parameter, measuring per-process peak RSS and held rows.

The point (VERDICT r4 #1/#8): with ovsShardExchange=range no process
ever materializes the full store input; process 0 checks the merged
store equals the single-process build EXACTLY.

Run: python tests/mp_scale_worker.py <pid> <nprocs> <port> <genome> <cov>
Env: JAX_PLATFORMS=cpu, XLA_FLAGS=--xla_force_host_platform_device_count=N
"""

import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid = int(sys.argv[1])
n_proc = int(sys.argv[2])
port = sys.argv[3]
gsize = int(float(sys.argv[4])) if len(sys.argv) > 4 else 1_000_000
cov = float(sys.argv[5]) if len(sys.argv) > 5 else 8.0

from canu_tpu.parallel.launch import init_distributed

p, n = init_distributed(f"127.0.0.1:{port}", n_proc, pid)
import jax

assert n == n_proc and jax.process_count() == n_proc
print(f"[{pid}] joined: {jax.device_count()} global devices", flush=True)

import numpy as np

from canu_tpu.ops import kmer as K
from canu_tpu.ops import minhash as MH
from canu_tpu.parallel.launch import barrier
from canu_tpu.parallel.shard_overlap import (
    process_sharded_store_rows,
    sharded_count_readset,
    sharded_find_candidates,
)
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu.stores.overlaps import OverlapStore

t0 = time.time()
g = random_genome(gsize, seed=7)
rs, _ = simulate_reads(g, coverage=cov, mean_len=3000, min_len=1500,
                       max_len=5000, error_rate=0.06, seed=8, circular=False)
print(f"[{pid}] sim: {rs.n_reads} reads {rs.total_bases} bases "
      f"({time.time()-t0:.1f}s)", flush=True)

t0 = time.time()
kc = sharded_count_readset(rs, k=16)
fk = K.frequent_kmers(kc, distinct_fraction=0.9995)
print(f"[{pid}] sharded meryl: {time.time()-t0:.1f}s", flush=True)

t0 = time.time()
sk = np.asarray(MH.build_sketches(rs, k=16, n_hashes=256, frequent=fk,
                                  block_size=256))
pairs = sharded_find_candidates(sk, min_matches=2)
print(f"[{pid}] candidates: {len(pairs)} ({time.time()-t0:.1f}s)",
      flush=True)

t0 = time.time()
mine = process_sharded_store_rows(
    rs, np.asarray(pairs)[:, :2], k=16, band=128, max_erate=0.25,
    min_overlap=500, chunk=256, min_shared=3,
)
verify_s = time.time() - t0
np.save(f"shard{pid:04d}.WORKING.npy", mine)
os.replace(f"shard{pid:04d}.WORKING.npy", f"shard{pid:04d}.npy")
barrier("scale-shards")

held = len(mine)
rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
print(f"[{pid}] verify+exchange: {verify_s:.1f}s held_rows={held} "
      f"peak_rss={rss_mb:.0f}MB", flush=True)

if pid == 0:
    shards = sorted(f for f in os.listdir(".")
                    if f.startswith("shard") and f.endswith(".npy"))
    t0 = time.time()
    OverlapStore.save_from_row_shards(shards, rs.n_reads, "scale.ovlStore")
    st_sh = OverlapStore.load("scale.ovlStore")
    # single-process reference build on the SAME candidates
    from canu_tpu.ops.align import verify_overlaps

    tab = verify_overlaps(rs, np.asarray(pairs)[:, :2], k=16, band=128,
                          max_erate=0.25, min_overlap=500, chunk=256,
                          min_shared=3)
    st_ref = OverlapStore.build(tab, rs.n_reads)
    assert len(st_sh) == len(st_ref), (len(st_sh), len(st_ref))
    cols = ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn",
            "b_end", "erate_q")
    sh_rows = {tuple(int(getattr(st_sh, c)[i]) for c in cols)
               for i in range(len(st_sh))}
    ref_rows = {tuple(int(getattr(st_ref, c)[i]) for c in cols)
                for i in range(len(st_ref))}
    assert sh_rows == ref_rows
    assert np.array_equal(st_sh.index, st_ref.index)
    total = len(st_ref)
    print(json.dumps({
        "genome": gsize, "reads": rs.n_reads, "candidates": int(len(pairs)),
        "store_rows": total, "held_rows_p0": held,
        "held_fraction": round(held / max(1, total), 3),
        "peak_rss_mb_p0": round(rss_mb), "verify_s": round(verify_s, 1),
    }), flush=True)
    print("MP_SCALE_OK", flush=True)

# all processes must reach the final barrier: p0's single-process
# equality rebuild runs MINUTES after the other workers finish their
# shards, and a worker that exits early trips jax.distributed's
# shutdown barrier, which then KILLS p0 mid-check (observed at 3 Mb,
# r5: p0 terminated by 'Shutdown barrier has failed' — the structural
# check had to be finished standalone from the on-disk shards).
barrier("scale-done")
