"""Smoke test of canu_tpu on one NVIDIA GPU: kernel parity, then one
bacterial-size assembly through the normal command-line entry point.

Usage:
  python chip_smoke.py               # one card: phases 1 and 2
  python chip_smoke.py --multichip   # every visible card: the mesh path

Phase 1 (kernel parity at real widths, bench read profile: 300 kb
genome, 12x, 10% error, 1.5-7.8 kb reads, so n_rows = 8192):
  * the verify engine kept on the GPU (ops.myers.default_impl) against
    the XLA Myers scan on one verify group: 512 pairs x MYERS_GROUP
    chunks x fwd+bwd = 4096 extensions of real candidate pairs;
  * the Myers engine against the plain banded DP (ops.align.banded_extend)
    on the group's own anchor-following bands, and on as many synthetic
    extensions with straight bands and with drifting bands (the latter
    also kept engine vs XLA scan);
  * one vote-engine block (votepile.pile_votes at block_geometry(7800))
    on the GPU against the same call on the CPU;
  * kmer.count_readset_device against count_readset_host at k=16, 22.

Precision: every kernel here is integer except the vote fold, and the
only matrix product in the program is that fold's einsum of bf16 0/1
(deletion counts <= 15) operands with preferred_element_type=f32.  It
has no f32 operands, so TF32 cannot apply, and its integer sums stay
below 2^24, where f32 is exact in any summation order.  So every
comparison below is exact.

Phase 2 simulates a 1 Mb genome at 20x (10% error, 1.5-7.8 kb reads,
seeds as scripts/scale_run.py), runs canu_tpu.__main__.main in this
process, judges the contigs with sim.bogus.evaluate_assembly and fails
unless misjoins == 0, genome fraction >= 0.98, identity >= 0.999 and
NG50 >= 500 kb.

--multichip runs only the mesh path over all visible cards (sharded
meryl at k=16 and k=22, ring candidates, sharded verify, distributed
store sort) on the phase-2 read set, each against its one-card result.

Artifacts go to _smoke/ (git-ignored).  The last stdout line is one
JSON object {"ok": true, "device": {...}}; any failure exits non-zero
before it.  Without a GPU the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "_smoke")

# phase-2 input (smallest genome the pipeline has assembled end to end)
E2E_GENOME = 1_000_000
E2E_COVERAGE = 20.0
GATE = {"misjoins": 0, "genome_fraction": 0.98, "identity": 0.999,
        "ng50": 500_000}


class SmokeFailure(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, ok: bool, detail: str, tolerance: str) -> None:
    """Print one comparison with its tolerance; raise when it failed."""
    say(f"CHECK {name}: {'PASS' if ok else 'FAIL'} — {detail}; "
        f"tolerance: {tolerance}")
    if not ok:
        raise SmokeFailure(name)


def memory_line(phase: str) -> None:
    import jax

    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.local_devices()]
    say(f"# peak_bytes_in_use after {phase}: {peaks}")


# ---- inputs -----------------------------------------------------------------


def bench_readset(genome: int = 300_000, coverage: float = 12.0):
    """The bench.py read profile (reads <= 7.8 kb, so n_rows = 8192)."""
    from canu_tpu.sim.simulate import random_genome, simulate_reads

    g = random_genome(genome, seed=42)
    return simulate_reads(
        g, coverage=coverage, mean_len=3500, min_len=1500, max_len=7800,
        error_rate=0.10, seed=43,
    )


def e2e_readset(genome: int, coverage: float):
    """The scale_run.py input: 1.5-7.8 kb reads at 10% error."""
    from canu_tpu.sim.simulate import random_genome, simulate_reads

    g = random_genome(genome, seed=7)
    rs, _ = simulate_reads(
        g, coverage=coverage, mean_len=3500, min_len=1500, max_len=7800,
        error_rate=0.10, seed=8,
    )
    return g, rs


def verify_group_inputs(rs, chunk: int = 512, n_chunks: int | None = None):
    """Extension inputs of the first Myers group of one verify pass over
    the read set's candidates, staged by verify_overlaps' own helpers
    (align.first_group_inputs).  Returns (ext_in, n_rows, max_rows)."""
    from canu_tpu.ops import align as AL
    from canu_tpu.ops import kmer as K
    from canu_tpu.ops import minhash as MH

    n_chunks = n_chunks or AL.MYERS_GROUP
    kc = K.count_readset_device(rs, k=16, block_size=128)
    fk = K.frequent_kmers(kc, distinct_fraction=0.9995)
    sk = MH.build_sketches(rs, k=16, n_hashes=512, frequent=fk,
                           block_size=128)
    pairs = MH.find_candidates(sk, min_matches=2, block_size=1024)
    need = chunk * n_chunks
    if len(pairs) < need:
        raise SmokeFailure(f"only {len(pairs)} candidates, need {need}")
    return AL.first_group_inputs(rs, pairs, chunk, n_chunks)


def synthetic_extensions(B: int, n_rows: int, seed: int, drift: bool):
    """Mutated-copy extension inputs in the layout banded_extend takes,
    reads cut to varied lengths on both sides.

    drift=False: substitutions only (0-15%) and the band on the
    diagonal, so the optimal path never leaves the band and Myers and
    the plain DP must agree exactly.  drift=True: indels too, and a band
    center that rises 0 or 1 column per row (0.6 on average), so the
    band loses the true diagonal and the optimal path runs along its
    edges; both band schedules then coincide."""
    import jax.numpy as jnp

    from canu_tpu.sim.simulate import mutate_read

    band = 128
    rng = np.random.default_rng(seed)
    a = np.zeros((B, n_rows), np.uint8)
    b = np.zeros((B, n_rows + band), np.uint8)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    mix = (0.4, 0.35, 0.25) if drift else (1.0, 0.0, 0.0)
    for i in range(B):
        rate = (0.0, 0.05, 0.1, 0.15)[i % 4]
        x = rng.integers(0, 4, int(rng.integers(n_rows // 2, n_rows)),
                         dtype=np.int64).astype(np.uint8)
        y = mutate_read(x, rate, rng, *mix)[: n_rows + band]
        if i % 3 == 0:
            y = y[: max(50, len(y) - int(rng.integers(0, 2000)))]
        if i % 5 == 0:
            x = x[: max(50, len(x) - int(rng.integers(0, 2000)))]
        a[i, : len(x)] = x
        a_len[i] = len(x)
        b[i, : len(y)] = y
        b_len[i] = len(y)
    if drift:
        steps = (rng.random((B, n_rows)) < 0.6).astype(np.int32)
        centers = np.concatenate(
            [np.zeros((B, 1), np.int32), np.cumsum(steps, axis=1,
                                                   dtype=np.int32)], axis=1)
    else:
        centers = np.broadcast_to(
            np.arange(n_rows + 1, dtype=np.int32)[None, :], (B, n_rows + 1))
    return tuple(map(jnp.asarray, (a, a_len, b, b_len,
                                   np.ascontiguousarray(centers))))


def vote_block_jobs(rs, truth, G: int, Lt: int, n_jobs: int, seed: int = 5):
    """One vote block: G templates (slots 0..G-1), n_jobs forward-strand
    evidence windows of <= Lt bases placed by the simulator's truth
    coordinates."""
    from canu_tpu.ops.votepile import VoteJobs

    rng = np.random.default_rng(seed)
    fwd = np.flatnonzero(truth.strand == 0)
    s, e = truth.start, truth.end
    tmpl = fwd[:G]
    rows = []
    for slot, t in enumerate(tmpl):
        ov = np.minimum(e[fwd], e[t]) - np.maximum(s[fwd], s[t])
        ev = fwd[(ov >= 500) & (fwd != t)]
        for j in rng.permutation(ev)[: max(1, n_jobs // G)]:
            lo, hi = max(s[t], s[j]), min(e[t], e[j])
            t_bgn = int(lo - s[t])
            e_lo = int(lo - s[j])
            span = int(min(hi - lo, Lt))
            rows.append((t, j, t_bgn, min(span, rs.length[t] - t_bgn), e_lo,
                         min(span, rs.length[j] - e_lo), slot))
    r = np.array(rows[:n_jobs], np.int64)
    return VoteJobs(
        t_idx=r[:, 0].astype(np.int32), e_idx=r[:, 1].astype(np.int32),
        t_bgn=r[:, 2].astype(np.int32), t_span=r[:, 3].astype(np.int32),
        e_lo=r[:, 4].astype(np.int32), e_span=r[:, 5].astype(np.int32),
        flipped=np.zeros(len(r), bool), slot=r[:, 6].astype(np.int32),
        weight=np.ones(len(r), np.float32),
    )


# ---- phase 1: kernel parity -------------------------------------------------


def check_myers_engines(ext_in, n_rows: int, max_rows: int, impl: str,
                        label: str = "") -> None:
    """The kept engine vs the XLA scan on the same extension inputs."""
    from canu_tpu.ops.myers import banded_extend_myers

    kw = dict(band=128, n_rows=n_rows, max_rows=max_rows,
              partial_cap_q=3500)
    got = banded_extend_myers(*ext_in, impl=impl, **kw)
    ref = banded_extend_myers(*ext_in, impl="xla", **kw)
    names = ("edits", "a_used", "b_used", "p_edits", "p_a", "p_b")
    bad = [n for n, x, y in zip(names, got, ref)
           if not np.array_equal(np.asarray(x), np.asarray(y))]
    B = ext_in[0].shape[0]
    check(f"myers.{impl}_vs_xla_scan{label}", not bad,
          f"{B} extensions x {n_rows} rows, 6 outputs"
          + (f", differing: {bad}" if bad else ""),
          "bit-exact (both run the same integer DP)")


def check_myers_vs_banded(ext_in, n_rows: int, impl: str, label: str,
                          exact: bool) -> None:
    """Myers vs the plain banded DP (ops.align.banded_extend) under
    tests/test_myers.py's contract: exact where the optimal path stays
    inside the band; otherwise Myers' edits never above the reference,
    endpoints within the reads and one read consumed."""
    from canu_tpu.ops.align import banded_extend
    from canu_tpu.ops.myers import banded_extend_myers

    B = ext_in[0].shape[0]
    ref = [np.asarray(x) for x in banded_extend(*ext_in, band=128,
                                                n_rows=n_rows)]
    got = [np.asarray(x) for x in banded_extend_myers(
        *ext_in, band=128, n_rows=n_rows, impl=impl)]
    if exact:
        same = all(np.array_equal(x, y) for x, y in zip(got, ref))
        check(f"myers_vs_banded_extend.{label}", same,
              f"{B} extensions x {n_rows} rows, (edits, a_used, b_used)",
              "exact (the optimal path stays in the band, so the band "
              "walls never bind)")
        return
    (e, au, bu), e_ref = got, ref[0]
    a_len, b_len = np.asarray(ext_in[1]), np.asarray(ext_in[3])
    ok = ((e <= e_ref).all() and (e >= 0).all() and (au <= a_len).all()
          and (bu <= b_len).all() and ((au == a_len) | (bu == b_len)).all())
    check(f"myers_vs_banded_extend.{label}", bool(ok),
          f"{B} extensions x {n_rows} rows; edits equal in "
          f"{int((e == e_ref).sum())}/{B}, lower in "
          f"{int((e < e_ref).sum())}, higher in {int((e > e_ref).sum())}",
          "Myers edits <= reference (under one band schedule its band "
          "holds one more column and prices every cell outside it as a "
          "real path, where the reference has INF; the two schedules "
          "coincide wherever the band target rises <= 1 column/row), "
          "endpoints within the reads, one read consumed")


def check_vote_block(rs, truth, gpu, cpu, max_len: int = 7800,
                     n_jobs: int = 256) -> None:
    """One pile_votes block on the GPU vs the same call on the CPU, at
    the geometry of templates up to max_len bases."""
    import jax

    from canu_tpu.ops.votepile import block_geometry, device_words, pile_votes

    G, Lt = block_geometry(max_len)
    jobs = vote_block_jobs(rs, truth, G, Lt, n_jobs=n_jobs)
    words, lens = device_words(rs)
    outs = []
    for dev in (gpu, cpu):
        with jax.default_device(dev):
            w = jax.device_put(words, dev)
            ln = jax.device_put(lens, dev)
            outs.append(np.asarray(pile_votes(w, ln, w, ln, jobs, G, Lt,
                                              band=256)))
    v_gpu, v_cpu = outs
    n_diff = int((v_gpu != v_cpu).sum())
    check("votepile.pile_votes_gpu_vs_cpu", n_diff == 0,
          f"G={G} Lt={Lt}, {len(jobs)} jobs, {v_gpu.size} vote cells, "
          f"{int(v_gpu.sum())} votes, {n_diff} cells differ",
          "exact (integer counts < 2^24 summed in f32 from bf16 0/1/<=15 "
          "inputs)")


def check_kmers(rs, ks=(16, 22)) -> None:
    from canu_tpu.ops import kmer as K

    for k in ks:
        dev = K.count_readset_device(rs, k=k, block_size=256).to_host()
        host = K.count_readset_host(rs, k=k)
        same = (np.array_equal(dev.unique, host.unique)
                and np.array_equal(dev.counts, host.counts))
        check(f"kmer.count_readset_device_vs_host.k{k}", same,
              f"{host.n_distinct} distinct, {host.n_total} instances",
              "exact (integer sort and count)")


def phase_kernels(gpu, cpu) -> None:
    from canu_tpu.ops.myers import default_impl

    impl = default_impl()
    say(f"# phase 1: kernel parity (kept verify engine: {impl})")
    rs, truth = bench_readset()
    say(f"# bench read set: {rs.n_reads} reads, {rs.total_bases} bases")
    t0 = time.time()
    ext_in, n_rows, max_rows = verify_group_inputs(rs)
    B = ext_in[0].shape[0]
    check_myers_engines(ext_in, n_rows, max_rows, impl, ".real")
    check_myers_vs_banded(ext_in, n_rows, impl, "real", exact=False)
    del ext_in
    check_myers_vs_banded(synthetic_extensions(B, n_rows, 1, drift=False),
                          n_rows, impl, "straight", exact=True)
    drift = synthetic_extensions(B, n_rows, 2, drift=True)
    check_myers_engines(drift, n_rows, n_rows, impl, ".drift")
    check_myers_vs_banded(drift, n_rows, impl, "drift", exact=False)
    del drift
    check_vote_block(rs, truth, gpu, cpu)
    check_kmers(rs)
    say(f"# phase 1 wall {time.time() - t0:.1f} s")
    memory_line("phase 1")


# ---- phase 2: end to end ----------------------------------------------------


def stage_walls(path: str) -> dict:
    walls: dict[str, float] = {}
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if "wall_s" in rec:
                walls[rec["stage"]] = walls.get(rec["stage"], 0.0) + rec["wall_s"]
    return walls


def phase_e2e(work_dir: str, genome: int = E2E_GENOME,
              coverage: float = E2E_COVERAGE, gate: dict = GATE) -> dict:
    from canu_tpu.__main__ import main as canu_main
    from canu_tpu.io import fastx
    from canu_tpu.sim.bogus import evaluate_assembly
    from canu_tpu.utils import bitpack

    say(f"# phase 2: e2e assembly, {genome} bp genome at {coverage}x")
    g, rs = e2e_readset(genome, coverage)
    os.makedirs(work_dir, exist_ok=True)
    raw = os.path.join(work_dir, "raw.fasta")
    fastx.write_fasta(raw, ((f"read{i+1}", rs.get_seq(i + 1))
                            for i in range(rs.n_reads)))
    say(f"# reads: {rs.n_reads}, {rs.total_bases} bases")
    t0 = time.time()
    rc = canu_main(["-p", "asm", "-d", work_dir, f"genomeSize={genome}",
                    "-pacbio-raw", raw])
    wall = time.time() - t0
    if rc != 0:
        raise SmokeFailure(f"canu_tpu exited {rc}")
    contigs = [bitpack.seq_to_codes(c.seq) for c in
               fastx.read_fastx(os.path.join(work_dir, "asm.contigs.fasta"))]
    ev = evaluate_assembly(g, contigs, k=21, circular=True)
    res = {
        "genome": genome, "coverage": coverage, "reads": rs.n_reads,
        "e2e_wall_s": wall, "n_contigs": ev.n_contigs, "ng50": ev.contig_ng50,
        "genome_fraction": ev.genome_fraction, "misjoins": ev.n_misjoins,
        "identity": ev.identity,
        "stage_walls_s": stage_walls(
            os.path.join(work_dir, "asm.stage-times.jsonl")),
    }
    say(f"# e2e wall {wall:.1f} s; {ev.summary()}")
    for st, w in res["stage_walls_s"].items():
        say(f"#   stage {st}: {w:.1f} s")
    ok = (ev.n_misjoins <= gate["misjoins"]
          and ev.genome_fraction >= gate["genome_fraction"]
          and ev.identity >= gate["identity"]
          and ev.contig_ng50 >= gate["ng50"])
    check("e2e.quality_gate", ok,
          f"misjoins {ev.n_misjoins}, genome fraction "
          f"{ev.genome_fraction:.4f}, identity {ev.identity:.5f}, NG50 "
          f"{ev.contig_ng50}",
          f"misjoins <= {gate['misjoins']}, genome fraction >= "
          f"{gate['genome_fraction']}, identity >= {gate['identity']}, "
          f"NG50 >= {gate['ng50']}")
    memory_line("phase 2")
    return res


# ---- --multichip: the mesh path ---------------------------------------------


def phase_multichip(rs, n_verify: int = 8192) -> None:
    """Sharded stages over all local devices, each vs one device."""
    import jax
    import jax.numpy as jnp

    from canu_tpu.ops import kmer as K
    from canu_tpu.ops import minhash as MH
    from canu_tpu.ops.align import _verify_kernel
    from canu_tpu.ops.minimizers import get_read_index
    from canu_tpu.parallel.shard_overlap import (
        default_mesh, sharded_count_readset, sharded_find_candidates,
        sharded_verify_candidates,
    )
    from canu_tpu.parallel.storesort import distributed_store_sort, make_flat_mesh

    n = len(jax.devices())
    mesh = default_mesh(n)
    say(f"# multichip: {n} devices, mesh {dict(mesh.shape)}")
    for k in (16, 22):
        sh = sharded_count_readset(rs, k=k, mesh=mesh)
        one = K.count_readset_device(rs, k=k, block_size=256).to_host()
        same = (np.array_equal(sh.unique, one.unique)
                and np.array_equal(sh.counts, one.counts))
        check(f"multichip.meryl.k{k}", same,
              f"{one.n_distinct} distinct, {one.n_total} instances",
              "exact (every k-mer counted on its one owner shard)")
    kc = K.count_readset_device(rs, k=16, block_size=256)
    fk = K.frequent_kmers(kc, distinct_fraction=0.9995)
    sk = MH.build_sketches(rs, k=16, n_hashes=256, frequent=fk,
                           block_size=256)
    pairs = sharded_find_candidates(sk, min_matches=2, mesh=mesh)
    ref = MH.find_candidates(sk, min_matches=2, block_size=1024)
    check("multichip.ring_candidates", np.array_equal(pairs, ref),
          f"{len(ref)} pairs", "exact (same candidate set and order)")

    sub = pairs[:n_verify]
    rows = sharded_verify_candidates(rs, sub, mesh=mesh, k=16, band=128)
    index = get_read_index(rs, k=16)
    one = np.asarray(_verify_kernel(
        index, jnp.asarray((sub[:, 0] - 1).astype(np.int32)),
        jnp.asarray((sub[:, 1] - 1).astype(np.int32)),
        jnp.zeros(len(sub), bool), 16, 128, index.words.shape[1] * 16,
        engine="xla", orient=True,
    ))
    check("multichip.sharded_verify", np.array_equal(rows, one),
          f"{len(sub)} of {len(pairs)} candidate pairs, 13 result columns",
          "bit-exact (same integer kernel on each device's slice)")

    st = np.stack([sub[:, 0], sub[:, 1], rows[:, 1], rows[:, 2]],
                  axis=1).astype(np.int32)
    srt = distributed_store_sort(st, n_reads=rs.n_reads,
                                 mesh=make_flat_mesh(n))
    srt1 = distributed_store_sort(st, n_reads=rs.n_reads,
                                  mesh=make_flat_mesh(1))
    host = st[np.lexsort((st[:, 1], st[:, 0]))]
    ok = (np.array_equal(srt, srt1)
          and np.array_equal(srt[:, :2], host[:, :2]))
    check("multichip.store_sort", ok, f"{len(st)} rows",
          "exact ((a_id, b_id) order equals the one-device sort and the "
          "host lexsort)")
    for d in jax.local_devices():
        ms = d.memory_stats() or {}
        say(f"# {d}: bytes_in_use {ms.get('bytes_in_use')}, "
            f"peak_bytes_in_use {ms.get('peak_bytes_in_use')}")


# ---- main -------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the mesh path over every visible card")
    args = ap.parse_args(argv)

    # the vote check compares against the CPU backend, so keep it
    # reachable when the platform list is pinned
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"
    from canu_tpu.utils.device import card_name, require_gpu

    devs = require_gpu("chip_smoke")
    import jax

    say(f"# card: {card_name()}")
    say(f"# jax {jax.__version__}; device_kind {devs[0].device_kind}; "
        f"{len(devs)} devices")
    say(f"# compile cache: {jax.config.jax_compilation_cache_dir}")
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.time()
    result: dict = {}
    if args.multichip:
        if len(devs) < 2:
            raise SystemExit("chip_smoke --multichip needs several GPUs")
        _, rs = e2e_readset(E2E_GENOME, E2E_COVERAGE)
        say(f"# read set: {rs.n_reads} reads, {rs.total_bases} bases")
        phase_multichip(rs)
    else:
        phase_kernels(devs[0], jax.devices("cpu")[0])
        result = phase_e2e(os.path.join(OUT_DIR, "e2e"))
    result["total_wall_s"] = time.time() - t0
    with open(os.path.join(OUT_DIR, "result.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    say(f"# total wall {result['total_wall_s']:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
