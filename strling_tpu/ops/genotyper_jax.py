"""Expansion genotyper model in pure JAX, batched over loci.

The reference genotyper's allele-2 model (genotyper.nim:117-140) is four
FLOPs per locus:

    allele2_bp = 2 ** (log2(sum_str_counts / max(1, depth) + 1) * COEF + B)

so the device form is one vectorized jit over every locus at once. The
scalar host path (core/genotyper.py, CPython libm) is the byte-stable
production formatter everywhere — including `call --distributed`, which
imports genotype_ls, NOT this module: the model is a few microseconds of
host work per locus, and the mesh-resident O/E percentile barrier in
call_dist is on-device only because a cross-process collective is REQUIRED
there. Whether a device dispatch pays here is not measured. This
module is kept as the model's device form for a future all-device cohort
pipeline and as a parity artifact, validated to ≤64 ulp against the
scalar spec (tests/test_cluster_jax.py::test_genotype_model_matches_scalar
and ::test_unplaced_model_matches_scalar; XLA's log2/exp2 may differ from
libm in the last bits, ~10 orders of magnitude below the 2-decimal output
precision).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# HTT-simulation-fitted constants (genotyper.nim:117-124,135-140)
ANCHORED_INTERCEPT = 4.3558142
ANCHORED_COEF = 0.7565329
UNPLACED_INTERCEPT = 8.9199168
UNPLACED_COEF = 0.7595562


def _anchored_lm(ssc, depth):
    """genotyper.nim:117-124 vectorized; NaN where sum_str_counts == 0."""
    y = (
        jnp.log2(ssc / jnp.maximum(1.0, depth) + 1.0) * ANCHORED_COEF
        + ANCHORED_INTERCEPT
    )
    return jnp.where(ssc == 0, jnp.nan, jnp.exp2(y))


def _unplaced_est(unplaced, depth):
    """genotyper.nim:135-140 vectorized."""
    y = (
        jnp.log2(unplaced / depth + 1.0) * UNPLACED_COEF
        + UNPLACED_INTERCEPT
    )
    return jnp.exp2(y)


def genotype_model_batch(sum_str_counts: np.ndarray, depth: np.ndarray,
                         rulen: np.ndarray) -> np.ndarray:
    """allele2 estimates (repeat units) for every locus in one dispatch.

    float64 end to end (x64 enabled for the call)."""
    with jax.enable_x64(True):
        fn = jax.jit(
            lambda s, d, r: _anchored_lm(s, d) / jnp.maximum(1.0, r)
        )
        out = fn(
            jnp.asarray(sum_str_counts, jnp.float64),
            jnp.asarray(depth, jnp.float64),
            jnp.asarray(rulen, jnp.float64),
        )
        return np.asarray(out)


def unplaced_model_batch(unplaced: np.ndarray, depth: np.ndarray,
                         rulen: np.ndarray) -> np.ndarray:
    """update_genotype's large-allele refinement (genotyper.nim:192-197)."""
    with jax.enable_x64(True):
        fn = jax.jit(lambda u, d, r: _unplaced_est(u, d) / r)
        out = fn(
            jnp.asarray(unplaced, jnp.float64),
            jnp.asarray(depth, jnp.float64),
            jnp.asarray(rulen, jnp.float64),
        )
        return np.asarray(out)
