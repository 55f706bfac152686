"""kmcex — accelerator k-mer counting and frequency encoding in JAX.

A from-scratch rebuild of the capabilities of kmcEx (lzhLab/kmcEx): count
canonical k-mers in FASTQ reads, encode (k-mer, count) pairs into the compact
probabilistic "KModel" (Bloom-filter bank + coupled bit arrays + exact rest
store), serialize it byte-compatibly (``header``/``km.bin``/``rest.bin``), and
answer approximate ``kmer_to_occ`` queries — with the counting and query hot
paths running batched on the GPU via JAX/XLA and the sequential encode phase
in native C++.

Layer map (cf. SURVEY.md §7):
  core/      k-mer math: 2-bit codec, canonicalization, MurmurHash64A, OccuBin
  io/        FASTQ ingestion + KMC database reader/writer (KMC1 + KMC2)
  count/     the counting engine (replaces the external ``kmc`` binary)
  model/     KModel encode: Bloom bank, coupled bit arrays, rest store, ser/de
  query/     batched on-device kmer_to_occ probe kernels
  parallel/  multi-chip sharding: mesh, all_to_all k-mer routing, merged counts
  native/    C++ runtime pieces (sequential bit-array encoder, FASTQ parser)

The framework requires 64-bit integer support (k-mers are 2-bit packed into
uint64); we enable jax x64 mode at import, before any tracing happens.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache.  Where JAX_COMPILATION_CACHE_DIR is set,
# JAX reads it itself and nothing is set here.  Otherwise the cache lives at
# a fixed path inside the checkout: the path is part of the cache key, so a
# directory that moved between runs would never hit.
_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from kmcex.config import KParams  # noqa: E402
from kmcex.model.kmodel import KModel, get_model, load_model  # noqa: E402

__version__ = "0.1.0"

__all__ = ["KParams", "KModel", "get_model", "load_model", "__version__"]
