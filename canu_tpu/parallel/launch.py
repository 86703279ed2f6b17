"""Multi-host bootstrap (the Grid_*.pm role).

The reference distributes work by submitting grid job arrays
(/root/reference/src/pipelines/canu/Grid_SGE.pm etc.) over a shared
filesystem.  Here it is one jax process per host, joined through
jax.distributed: device collectives replace the filesystem, and the
"job array index" becomes (process_index, local device mesh position).

init_distributed() wires a process into the cluster from standard
launcher environments, mirroring the reference's detect-then-configure
grid probing (canu.pl:294-319):

  * SLURM: SLURM_NTASKS/SLURM_PROCID/SLURM_STEP_NODELIST;
  * manual: coordinator address + process count + id arguments.

Without either, the process runs alone.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class HostShard:
    """This host's slice of the read set (1-based id range, inclusive-lo,
    exclusive-hi), the job-array partitioning of OverlapMhap.pm:191-296
    re-expressed as a deterministic function of process index."""

    process_index: int
    process_count: int
    lo: int
    hi: int

    @property
    def n_local(self) -> int:
        return self.hi - self.lo


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Join the jax distributed runtime; returns (process_index, count).

    Safe to call single-host (no-op, returns (0, 1)).  Environment
    detection order: explicit args > SLURM.
    """
    import jax

    if coordinator is None and "SLURM_NTASKS" in os.environ:
        n = int(os.environ["SLURM_NTASKS"])
        if n > 1:
            coordinator = os.environ.get("SLURM_LAUNCH_NODE_IPADDR", "") + ":12321"
            num_processes = n
            process_id = int(os.environ["SLURM_PROCID"])
    if coordinator is not None:
        try:
            # CPU multi-process needs an explicit cross-process
            # collectives implementation (GPUs bring NCCL)
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def host_read_shard(n_reads: int, process_index: int, process_count: int) -> HostShard:
    """Contiguous 1-based read-id range owned by this host."""
    per = (n_reads + process_count - 1) // process_count
    lo = 1 + process_index * per
    hi = min(1 + (process_index + 1) * per, n_reads + 1)
    return HostShard(process_index, process_count, lo, max(lo, hi))


def all_host_shards(n_reads: int, process_count: int) -> list[HostShard]:
    return [host_read_shard(n_reads, p, process_count) for p in range(process_count)]


def is_distributed() -> bool:
    import jax

    return jax.process_count() > 1


def is_writer() -> bool:
    """True on the process that owns shared-file writes (process 0, or
    any single-process run).  The reference's equivalent is the grid
    executive: exactly one canu.pl writes stage outputs while job arrays
    write only their own per-jobid files (Execution.pm:1036-1276)."""
    import jax

    return jax.process_count() == 1 or jax.process_index() == 0


def barrier(name: str) -> None:
    """Cross-process sync point (no-op single-process).

    Used by the stage runner to make file-existence resume coherent
    across processes: done() is only consulted when every process has
    passed the previous stage's writes."""
    import jax

    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
