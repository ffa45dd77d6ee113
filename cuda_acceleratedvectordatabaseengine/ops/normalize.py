"""Vector normalization (reference K6: ``engine/kernels.cuh:357-385``).

The reference launches a CUDA kernel that L2-normalizes vectors in place with
``rsqrtf(norm + 1e-8)`` for the cosine metric. Here it is a single fused
XLA elementwise expression.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NORMALIZE_EPS = 1e-8


def l2_normalize(x: jax.Array, eps: float = NORMALIZE_EPS) -> jax.Array:
    """L2-normalize along the last axis, computed in fp32, cast back to input
    dtype. Mirrors ``normalize_vectors_kernel`` (``kernels.cuh:357-385``)."""
    xf = x.astype(jnp.float32)
    inv = jax.lax.rsqrt(jnp.sum(xf * xf, axis=-1, keepdims=True) + eps)
    return (xf * inv).astype(x.dtype)
