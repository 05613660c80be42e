"""Device-mesh helpers for multi-chip sharding.

The reference has no in-process parallelism at all (SURVEY.md §2: per-sample /
per-chromosome fan-out via bpipe, files as the only transport). The device-mesh
equivalents (SURVEY.md parallelism table):

- read-stream data parallelism ("data" axis): batches of packed reads sharded
  across chips for the extract scan; per-chip fragment-length and repeat-unit
  histograms combined with psum.
- locus-space sharding ("locus" axis): (tid, repeat)-bucketed evidence
  distributed across chips for clustering/genotyping; candidate bounds
  combined with all_gather.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, locus_axis: bool = False) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if locus_axis and n >= 4 and n % 2 == 0:
        arr = np.array(devs).reshape(n // 2, 2)
        return Mesh(arr, ("data", "locus"))
    return Mesh(np.array(devs), ("data",))
