"""Time the two Myers verify engines, the Triton kernel and the XLA
scan, in turns in one process on one GPU.

Inputs are bench.py's read profile (300 kb genome, 12x, 10% error,
1.5-7.8 kb reads, n_rows = 8192) and its first verify group: 512 pairs
x MYERS_GROUP chunks x fwd+bwd = 4096 extensions.  Three readings, each
in the order xla, triton, triton, xla per round after one warm-up call:

  call_s  the whole banded_extend_myers call (prep, pack/init, row loop,
          finish), one block_until_ready on its outputs at the end;
  loop_s  the row loop alone on prepared inputs: the one kernel launch,
          or every _myers_segment dispatch of the XLA scan, with one
          block_until_ready at the end (no sync between segments);
  verify_s  the verify stage of bench.py's overlap pass (warm).

Usage: python scripts/myers_times.py [rounds] [out.json]
Prints one JSON line per reading, then the card.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def _timed(fn) -> float:
    t = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t


def main() -> None:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    out = sys.argv[2] if len(sys.argv) > 2 else None

    from bench import run_overlap_pass
    from canu_tpu.ops import align as AL
    from canu_tpu.ops import kmer as K
    from canu_tpu.ops import minhash as MH
    from canu_tpu.ops import myers as M
    from canu_tpu.ops.pallas.myers_triton import BLOCK, myers_run_triton
    from canu_tpu.sim.simulate import random_genome, simulate_reads
    from canu_tpu.utils.device import card_name, require_gpu

    require_gpu("myers_times")
    g = random_genome(300_000, seed=42)
    rs, _ = simulate_reads(g, coverage=12, mean_len=3500, min_len=1500,
                           max_len=7800, error_rate=0.10, seed=43)
    fk = K.frequent_kmers(K.count_readset_device(rs, k=16, block_size=128),
                          distinct_fraction=0.9995)
    sk = MH.build_sketches(rs, k=16, n_hashes=512, frequent=fk,
                           block_size=128)
    pairs = MH.find_candidates(sk, min_matches=2, block_size=1024)
    ext_in, n_rows, max_rows = AL.first_group_inputs(rs, pairs)
    a, a_len, b, b_len, centers = ext_in
    B = a.shape[0]
    kw = dict(band=128, n_rows=n_rows, max_rows=max_rows, partial_cap_q=3500)

    # prepared row-loop inputs of each engine (as banded_extend_myers
    # stages them; B is a multiple of BLOCK, so no padding)
    assert B % BLOCK == 0
    seg = M.SEGMENT
    n_seg = -(-n_rows // seg)
    run_segs = -(-max_rows // seg)
    s_segs, ent_segs, o0 = M._myers_prep(b_len, centers, 128, n_seg, seg)
    cap_q = jnp.int32(3500)
    runq = 1
    while runq < run_segs:
        runq *= 2
    runq = min(runq, n_seg)
    packed = M._pack_inputs(a, b, s_segs, ent_segs, runq * seg)
    carry_t = M._carry_pack(M._myers_init(b, b_len, a_len, o0, 128))

    def loop_triton():
        return myers_run_triton(carry_t, *packed, a_len, b_len, cap_q)

    def loop_xla():
        carry = jax.block_until_ready(M._myers_init(b, b_len, a_len, o0, 128))
        t = time.perf_counter()
        for s in range(run_segs):
            carry = M._myers_segment(carry, a, b, s_segs[s], ent_segs[s],
                                     a_len, b_len, jnp.int32(s * seg), cap_q,
                                     band=128, seg=seg)
        jax.block_until_ready(carry)
        return time.perf_counter() - t

    def verify_pass():
        timing: dict = {}
        run_overlap_pass(rs, fk, timing)
        return timing["verify"]

    readings: dict = {}

    def rec(name, impl, value):
        readings.setdefault(f"{name}.{impl}", []).append(value)

    real_default = M.default_impl
    for impl in ("xla", "triton"):  # warm-up: compile every shape
        M.default_impl = lambda impl=impl: impl
        _timed(lambda: M.banded_extend_myers(*ext_in, impl=impl, **kw))
        rec("cold_verify_s", impl, verify_pass())
    loop_xla()
    _timed(loop_triton)
    for _ in range(rounds):
        for impl in ("xla", "triton", "triton", "xla"):
            rec("call_s", impl, _timed(
                lambda: M.banded_extend_myers(*ext_in, impl=impl, **kw)))
            rec("loop_s", impl,
                loop_xla() if impl == "xla" else _timed(loop_triton))
            M.default_impl = lambda impl=impl: impl
            rec("verify_s", impl, verify_pass())
    M.default_impl = real_default

    card = card_name()
    res = {"card": card, "kind": jax.devices()[0].device_kind,
           "extensions": B, "n_rows": n_rows, "max_rows": max_rows,
           "rounds": rounds, "readings": readings}
    for name, vals in readings.items():
        print(json.dumps({name: vals}), flush=True)
    print(f"# card: {card}", flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
