"""Batched negacyclic monomial rotation: p(X) -> X^amt * p(X) mod X^N+1.

The blind rotation (SURVEY.md E6) multiplies each accumulator polynomial by a
per-ciphertext monomial X^amt, amt in [0, 2N).  A per-row dynamic rotation is
hostile to SIMD hardware, so we use a barrel shifter: log2(2N) stages of
STATIC rolls of the whole batch (vectorized, XLA friendly), each
selected per batch element by one bit of the rotation amount.  Total cost is
log2(2N) * 2 elementwise passes -- a small fraction of the external-product
matmul cost (see SURVEY.md section 7 "hard parts" #3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def negacyclic_roll_static(x: jax.Array, s: int) -> jax.Array:
    """X^s * p for a static s in [0, N): roll with sign flip on wrapped coeffs."""
    N = x.shape[-1]
    s = s % (2 * N)
    if s >= N:
        return -negacyclic_roll_static(x, s - N)
    if s == 0:
        return x
    y = jnp.roll(x, s, axis=-1)
    wrap = jnp.arange(N) < s  # coefficients that wrapped around pick up -1
    return jnp.where(wrap, -y, y)


def negacyclic_rotate(x: jax.Array, amt: jax.Array) -> jax.Array:
    """X^amt * p, batched: x (..., N) int32, amt (...) int32 in [0, 2N).

    amt broadcasts against x's leading dims (e.g. x (B, K, N), amt (B,) or
    (B, 1) -- pass amt with explicit singleton dims to control broadcasting).
    """
    N = x.shape[-1]
    amt = jnp.asarray(amt, jnp.int32)[..., None]  # align with coeff axis
    y = x
    for k in range(N.bit_length()):  # stages 1, 2, ..., N (N == full negation)
        s = 1 << k
        bit = (amt >> k) & 1
        rolled = negacyclic_roll_static(y, s) if s < N else -y
        y = jnp.where(bit == 1, rolled, y)
    return y


def modswitch_2n(a: jax.Array, N: int) -> jax.Array:
    """Torus32 -> Z_{2N}: round(a * 2N / 2^32), TFHE's modSwitchFromTorus32."""
    log2_2n = (2 * N).bit_length() - 1
    shift = 32 - log2_2n
    ua = a.astype(jnp.uint32) + jnp.uint32(1 << (shift - 1))
    return (ua >> shift).astype(jnp.int32) & (2 * N - 1)
