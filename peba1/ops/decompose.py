"""Gadget (base-Bg) decomposition of torus32 polynomials.

Exact reimplementation of TFHE's ``tGswTorus32PolynomialDecompH`` semantics
(the digit extraction behind every external product, SURVEY.md E6): signed
balanced digits d_p in [-Bg/2, Bg/2) with a rounding offset so that
sum_p d_p * 2^(32 - p*bgbit) reconstructs the input to l*bgbit bits of
precision and decompose(0) == 0 exactly.

Digits fit int8 for all supported parameter sets (Bg <= 2^8), which is what
lets the external product run as an int8 GEMM (ops/poly.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..params import TfheParams


def gadget_offset(params: TfheParams) -> int:
    """Digit-balancing plus round-to-nearest offset, as unsigned 32-bit.

    sum_{p=1..l} 2^(32 - p*bgbit) * Bg/2   (balanced digits in [-Bg/2, Bg/2))
    + 2^(32 - l*bgbit - 1)                 (half-ulp: round-to-nearest)

    Without the half-ulp term the remainder x - recompose(decompose(x)) is
    uniform in (0, ulp] -- a systematic +ulp/2 bias per coefficient whose
    key-convolved accumulation over the blind rotation measured ~7.6x the
    centered-remainder noise (scripts/diag.py noise); at l*bgbit = 16
    (the l=2/Bg=2^8 gadget) that breaks gate decoding outright.  TFHE v1.x
    itself does not round (its l*bgbit = 21 hides the bias); we deviate --
    conformance is pinned at gate outputs, not internal noise (SURVEY.md
    hard part #1).
    """
    off = 1 << (32 - params.l * params.bgbit - 1)
    for p in range(1, params.l + 1):
        off += (1 << (32 - p * params.bgbit)) * params.half_bg
    return off % (1 << 32)


def decompose(x: jax.Array, params: TfheParams) -> jax.Array:
    """Decompose torus32 (...,) -> digits (..., l) int8 in [-Bg/2, Bg/2)."""
    off = jnp.uint32(np.uint32(gadget_offset(params)))
    u = x.astype(jnp.uint32) + off
    ds = []
    for p in range(1, params.l + 1):
        d = (u >> (32 - p * params.bgbit)) & (params.bg - 1)
        ds.append((d.astype(jnp.int32) - params.half_bg).astype(jnp.int8))
    return jnp.stack(ds, axis=-1)


def recompose(digits: jax.Array, params: TfheParams) -> jax.Array:
    """sum_p digits[..., p] * 2^(32-(p+1)*bgbit) as int32 (approximate inverse)."""
    acc = jnp.zeros(digits.shape[:-1], jnp.int32)
    for p in range(params.l):
        acc = acc + (digits[..., p].astype(jnp.int32) << (32 - (p + 1) * params.bgbit))
    return acc
