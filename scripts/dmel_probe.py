"""BASELINE config 5 probe: D. melanogaster-scale 140 Mb / 30x on ONE chip.

A full single-chip e2e at this scale is expected to take hours of verify
device time; within a bounded run clock this probe MEASURES every stage
that fits and projects the rest from measured per-unit rates, writing
an honest `result.json`:

  measured: sim, gatekeeper (native scanner), cor-meryl (host-fallback
            counter — the >2^27-instance route), sketch build (device),
            candidate matching (LSH hash-join — the O(N*H) path;
            the block matrix would be ~10^6 block pairs), and banded
            verification THROUGHPUT on a random candidate sample;
  projected: cor-overlap wall (sample rate x candidate count) and the
            full e2e (stage ratios from the completed 4.6 Mb run).

Usage: python scripts/dmel_probe.py [genome] [cov] [workdir] [sample]
Defaults: 140e6 30 _scale/dmel 40000.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    gsize = int(float(sys.argv[1])) if len(sys.argv) > 1 else 140_000_000
    cov = float(sys.argv[2]) if len(sys.argv) > 2 else 30.0
    wd = sys.argv[3] if len(sys.argv) > 3 else "_scale/dmel"
    sample_n = int(sys.argv[4]) if len(sys.argv) > 4 else 40_000
    os.makedirs(wd, exist_ok=True)
    res: dict = {"genome": gsize, "coverage": cov, "mode": "probe",
                 "stage_walls_s": {}}

    def _checkpoint():
        # a device OOM mid-probe must not lose the measured walls
        with open(os.path.join(wd, "result.json"), "w") as fh:
            json.dump(res, fh, indent=1)

    def lap(name, t0):
        dt = time.time() - t0
        res["stage_walls_s"][name] = round(dt, 1)
        print(f"# {name}: {dt:.1f}s", flush=True)
        _checkpoint()
        return time.time()

    from canu_tpu.stores.readset import ReadSet

    # Two-phase operation so the ~1.26M-read simulation (host, CPU-only)
    # can run concurrently with other device work: invoke once with
    # CANU_TPU_PROBE_SIMONLY=1 JAX_PLATFORMS=cpu to build the store, then
    # again without the env to run the device stages from the saved store.
    store = os.path.join(wd, "probe.gkpStore")
    t = time.time()
    if os.path.isdir(store):
        rs = ReadSet.load(store)
        t = lap("gatekeeper-store", t)
    else:
        from canu_tpu.sim.simulate import random_genome, simulate_reads

        g = random_genome(gsize, seed=7)
        rs, _ = simulate_reads(
            g, coverage=cov, mean_len=3500, min_len=1500, max_len=7800,
            error_rate=0.10, seed=8,
        )
        print(f"# sim: {rs.n_reads} reads, {rs.total_bases} bases",
              flush=True)
        t = lap("sim", t)
        rs.save(store)
        rs = ReadSet.load(store)
        t = lap("gatekeeper-store", t)
    res["reads"] = rs.n_reads
    res["bases"] = int(rs.total_bases)
    if os.environ.get("CANU_TPU_PROBE_SIMONLY"):
        with open(os.path.join(wd, "sim.json"), "w") as fh:
            json.dump(res, fh, indent=1)
        print("# sim-only: store written, exiting", flush=True)
        return

    from canu_tpu.ops import kmer as K
    from canu_tpu.ops import minhash as MH

    # cor-meryl: 4.2e9 instances routes to the host counter.  This
    # stage is pure host CPU, so it can ALSO run as its own CPU-only
    # process (CANU_TPU_PROBE_MERYLONLY=1 JAX_PLATFORMS=cpu) concurrent
    # with other device work; the result is checkpointed and reloaded.
    fk_path = os.path.join(wd, "probe.frequent.npz")
    if os.path.exists(fk_path):
        z = np.load(fk_path)
        fk = K.FrequentKmers(
            k=int(z["k"]), kmers=z["kmers"], fraction=z["fraction"],
            threshold=int(z["threshold"]), total_kmers=int(z["total"]),
        )
        res["meryl_engine"] = "host-fallback (checkpointed)"
        res["frequent_mers"] = int(fk.n)
        t = lap("cor-meryl-load", t)
    else:
        # CANU_TPU_PROBE_MERYL_SAMPLE=<frac>: count a random read
        # subsample instead of all 4.2e9 instances.  The frequent table
        # is the TOP 0.05% of distinct mers — high-count mers are
        # massively oversampled at any fraction, so the selected set is
        # nearly identical while the host count drops proportionally
        # (the full-set host counter spends most of its wall in kernel
        # page-fault churn on this box's 2 cores).
        frac = float(os.environ.get("CANU_TPU_PROBE_MERYL_SAMPLE", "1"))
        rs_m = rs
        if frac < 1.0:
            sel = np.random.default_rng(5).random(rs.n_reads) < frac
            ids = np.flatnonzero(sel) + 1
            from canu_tpu.stores.readset import ReadSet as _RS

            rs_m = _RS.from_codes_list(
                [rs.get_codes(int(i)) for i in ids]
            )
            res["meryl_sample_fraction"] = frac
        kc = K.count_readset_device(rs_m, k=16, block_size=256)
        is_host = not hasattr(kc, "to_host")
        fk = K.frequent_kmers(kc, distinct_fraction=0.9995)
        res["meryl_engine"] = "host-fallback" if is_host else "device"
        res["frequent_mers"] = int(fk.n)
        t = lap("cor-meryl", t)
        np.savez(fk_path, k=fk.k, kmers=fk.kmers, fraction=fk.fraction,
                 threshold=fk.threshold, total=fk.total_kmers)
        if os.environ.get("CANU_TPU_PROBE_MERYLONLY"):
            res["stage_walls_s"]["note"] = "meryl-only pass"
            with open(os.path.join(wd, "meryl.json"), "w") as fh:
                json.dump(res, fh, indent=1)
            print("# meryl-only: frequent table written, exiting",
                  flush=True)
            return

    cand_path = os.path.join(wd, "probe.candidates.npy")
    if os.path.exists(cand_path):
        pairs = np.load(cand_path)
        res["candidates"] = int(len(pairs))
        res["stage_walls_s"]["match-join"] = res["stage_walls_s"].get(
            "match-join", 0.0)
        t = lap("candidates-load", t)
    else:
        sk = MH.build_sketches(rs, k=16, n_hashes=512, frequent=fk,
                               block_size=256)
        sk = np.asarray(sk)
        t = lap("sketch", t)

        pairs = MH.find_candidates_join(sk, min_matches=2)
        del sk
        res["candidates"] = int(len(pairs))
        t = lap("match-join", t)
        np.save(cand_path, pairs[:, :2])

    # verification throughput on a random sample (same kernel + params
    # as the pipeline's cor pass: partial overlaps, band 256)
    from canu_tpu.ops.align import verify_overlaps

    rng = np.random.default_rng(1)
    sel = rng.choice(len(pairs), min(sample_n, len(pairs)), replace=False)
    sub = pairs[np.sort(sel)][:, :2].astype(np.int64)
    # Verify against a COMPACT subset readset holding only the reads the
    # sample touches: staging the full 1.2M-read store's code planes to
    # the device OOMs a 16 GB device, and the sharded pipeline never does
    # that either — each process stages only its shard's reads.  Subset
    # + id remap bounds device memory at any total scale.
    uniq = np.unique(sub)
    remap = np.zeros(int(uniq.max()) + 1, np.int64)
    remap[uniq] = np.arange(1, len(uniq) + 1)
    from canu_tpu.stores.readset import ReadSet as _RS

    rs_sub = _RS.from_codes_list([rs.get_codes(int(i)) for i in uniq])
    sub = remap[sub]
    res["verify_subset_reads"] = int(len(uniq))
    t = lap("verify-subset-build", t)
    t0 = time.time()
    ov = verify_overlaps(rs_sub, sub, k=16, band=256, max_erate=0.30,
                         min_overlap=500, chunk=512, min_shared=4,
                         partial=True)
    dt = time.time() - t0
    rate = len(sub) / dt
    res["verify_sample"] = {
        "candidates": int(len(sub)), "overlaps": int(len(ov)),
        "wall_s": round(dt, 1), "cand_per_s": round(rate, 1),
    }
    print(f"# verify sample: {len(sub)} cands -> {len(ov)} ovl in "
          f"{dt:.1f}s = {rate:.0f} cand/s", flush=True)
    res["stage_walls_s"]["verify-sample"] = round(dt, 1)

    # projection: cor-overlap = match + candidates/rate; e2e from the
    # completed 4.6 Mb run's stage shares (cor-overlap was ~40% of wall)
    proj_cor_overlap = res["stage_walls_s"]["match-join"] + len(pairs) / rate
    res["projected"] = {
        "cor_overlap_s": round(proj_cor_overlap, 0),
        "note": "single-chip cor-overlap projection = match wall + "
                "candidates / measured sample rate; e2e would add "
                "correction/trim/assembly at the 4.6 Mb run's stage "
                "ratios (cor-overlap ~40% of total)",
        "e2e_s_est": round(proj_cor_overlap / 0.40, 0),
    }
    with open(os.path.join(wd, "result.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
