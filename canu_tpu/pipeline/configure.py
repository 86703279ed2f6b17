"""Resource solver (the Configure.pm role).

The reference computes per-stage memory/thread envelopes from
genomeSize and grid host classes
(/root/reference/src/pipelines/canu/Configure.pm:522-730, grid
bin-packing :184-454).  The device-side equivalents of those decisions:

  * maxMemory (host GB) bounds the in-RAM overlap build — above the
    derived pair count, verified overlaps stream to the spill file and
    the native external merge sort — and the sort's own memory budget;
  * maxThreads bounds the native sorter's worker threads;
  * the DEVICE vote-engine budgets (votepile.BLOCK_POS_BUDGET /
    CHUNK_CELL_BUDGET) are sized from the accelerator's reported HBM,
    not from maxMemory — host RAM says nothing about chip memory.

Returns a dict of the decisions for the report/log.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Resources:
    spill_pairs: int
    sort_mem_bytes: int
    sort_threads: int
    decisions: dict


# bytes per overlap row across the build path (REC on disk + columnar
# store copy + mirror), with headroom
_BYTES_PER_PAIR = 120


def configure_resources(cfg, log=None) -> Resources:
    import canu_tpu.ops.votepile as VP

    decisions: dict = {}
    mem_gb = int(cfg.get("maxMemory"))
    threads = int(cfg.get("maxThreads"))
    spill_pairs = int(cfg.get("ovlSpillPairs"))
    sort_mem = 1 << 30
    if mem_gb > 0:
        cap = max(1_000_000, (mem_gb << 30) // 4 // _BYTES_PER_PAIR)
        if cap < spill_pairs:
            spill_pairs = cap
            decisions["ovlSpillPairs"] = cap
        sort_mem = max(64 << 20, (mem_gb << 30) // 8)
        decisions["sortMemBytes"] = sort_mem
    sort_threads = max(0, threads)  # 0 = native default (hw concurrency)
    if threads > 0:
        decisions["sortThreads"] = threads

    # device vote budgets from HBM: DP state is the peak consumer
    # ([n_rows, B, window] bytes, window = band + 4*SROW); keep it under
    # ~1/6 of the chip so planes + votes + XLA temps fit comfortably
    try:
        import jax

        stats = jax.local_devices()[0].memory_stats() or {}
        hbm = int(stats.get("bytes_limit", 0))
    except Exception:
        hbm = 0
    if hbm > 0:
        from ..ops.trace import SMAX, SROW

        window = 256 + SMAX * SROW
        cells = max(1 << 19, min(1 << 23, (hbm // 6) // window))
        if cells != VP.CHUNK_CELL_BUDGET:
            VP.CHUNK_CELL_BUDGET = cells
            decisions["chunkCellBudget"] = cells
    if log is not None and decisions:
        log.info("configure: %s", decisions)
    return Resources(spill_pairs, sort_mem, sort_threads, decisions)
