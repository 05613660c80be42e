"""strling_tpu — JAX STR-expansion engine.

A from-scratch reimplementation of the capabilities of quinlan-lab/STRling
(Nim + htslib) built around a batched device scan:

- host ingest (BAM/BGZF/FASTA parsing, batch packing) in C++ (strling_tpu.io)
- the per-read repeat-unit detector (the reference's runtime bottleneck,
  src/strpkg/utils.nim:236-271) as a batched JAX program over
  2-bit-packable read tensors (strling_tpu.ops)
- clustering / genotyping / merge / call pipelines (strling_tpu.core)
- multi-chip sharding via jax.sharding Mesh (strling_tpu.parallel)

Public pipeline entry points mirror the reference CLI:
  index / extract / merge / call / outliers (+ pull_region, simulate).
"""

from strling_tpu.version import __version__, STRLING_VERSION, BIN_FMT_VERSION

__all__ = ["__version__", "STRLING_VERSION", "BIN_FMT_VERSION"]
