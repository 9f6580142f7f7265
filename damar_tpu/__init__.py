"""damar_tpu — a GPU-accelerated long-read overlapper and assembly engine.

A from-scratch rebuild of the capabilities of MartinPippel/DAmar
(Dazzler/MARVEL lineage): block-split 2-bit read databases, k-mer
seed + sort-merge hit detection, trace-point local alignment,
tandem/repeat masking, read scrubbing (patch/trim/split), overlap
filtering, and string-graph touring to contigs — with the alignment
compute path implemented as batched JAX/Pallas kernels over
HBM-resident read blocks, and scale-out via jax.sharding meshes.

Layer map (mirrors SURVEY.md §1):
  formats/   — byte-level .db/.idx/.bps, .las, .anno/.data track codecs (L0)
  core/      — typed phase configs, device block layout (L0)
  ops/       — JAX/Pallas compute kernels: k-mer seeding, banded DP waves,
               trace-point alignment (L2 core)
  pipeline/  — tool-level drivers: ingest, overlap, las ops, masking,
               scrubbing, graph, touring, planning (L1-L8)
  parallel/  — mesh construction, block sharding, ring rotation (L8)
  utils/     — read simulator, DUST, small helpers
"""

__version__ = "0.1.0"

import os as _os


def _enable_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache.  JAX reads
    JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise the
    cache lives at one fixed path inside the checkout (<repo>/.jax_cache,
    gitignored), since the path is part of the cache key.  The
    alignment kernels compile large loop nests, so every process after
    the first starts warm.  Opt out with DAMAR_NO_COMPILE_CACHE=1."""
    if _os.environ.get("DAMAR_NO_COMPILE_CACHE"):
        return
    import jax
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")

_enable_compilation_cache()
