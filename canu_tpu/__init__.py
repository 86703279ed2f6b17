"""canu_tpu — a long-read genome assembly framework in JAX.

A from-scratch re-design of the capabilities of Canu v1.6 (hierarchical
correct -> trim -> assemble long-read assembly; reference mounted at
/root/reference) for JAX/XLA/Pallas on an accelerator (an NVIDIA GPU):

  * k-mer counting (meryl equivalent)        -> canu_tpu.ops.kmer
  * MinHash sketch overlap (MHAP equivalent) -> canu_tpu.ops.minhash
  * seed-and-extend overlap verification
    (overlapInCore equivalent)               -> canu_tpu.ops.align
  * falcon-sense read correction             -> canu_tpu.stages.correction
  * overlap-based trimming                   -> canu_tpu.stages.trimming
  * best-overlap-graph contigging (bogart)   -> canu_tpu.graph
  * consensus (utgcns equivalent)            -> canu_tpu.stages.consensus

Data layer (canu_tpu.stores) replaces gkStore/ovStore/tgStore with
numpy-backed, jnp-loadable columnar stores.  Pipeline orchestration
(canu_tpu.pipeline) replaces the Perl executive with a resumable stage
state machine.  All hot loops run on device; graph walking and
orchestration stay on host.

This is NOT a port: no code is copied from the reference; citations in
docstrings are to reference behavior being matched, e.g.
/root/reference/src/pipelines/canu.pl:653-764 for phase sequencing.
"""

__version__ = "0.1.0"

import os as _os


# compile cache used when JAX_COMPILATION_CACHE_DIR is unset: a fixed
# path at the checkout root, so every process of a run (and every run
# from the same checkout) hits the entries the others wrote
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _enable_compile_cache() -> None:
    """Persistent XLA compile cache.  JAX_COMPILATION_CACHE_DIR, when set,
    is honoured as JAX reads it; otherwise the cache lives in
    DEFAULT_CACHE_DIR.  Opt out with CANU_TPU_NO_COMPILE_CACHE=1."""
    if _os.environ.get("CANU_TPU_NO_COMPILE_CACHE"):
        return
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_compile_cache()
