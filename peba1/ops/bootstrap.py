"""Batched gate bootstrapping: blind rotation + sample extract + key switch.

This replaces TFHE's ``tfhe_bootstrap_FFT`` (SURVEY.md section 3.5) -- the
code path behind every single ``boots*`` call in the reference.  Design
inversion vs the reference (SURVEY.md section 7): instead of one synchronous
scalar bootstrap per gate call, a whole BATCH of gate bootstraps executes as
one jitted program:

  1. modswitch all phases to Z_2N                       (elementwise)
  2. init accumulators = X^{-b_bar} * testvector        (barrel-shift selects)
  3. n CMUX steps, each: barrel-rotate, gadget-decompose (one elementwise
     pass), then ONE s8 x s8 -> s32 GEMM contracting all (k+1)*l digit
     polys x batch against that step's negacyclic-Toeplitz weights --
     precomputed (CloudKey.bk_w) or built in the graph from the small
     generator key (ops/poly.toeplitz_weights) -- then limb recombination
     + accumulate
  4. sample extract                                     (slicing)
  5. key switch as ONE digit-valued int8 matmul

Exact integer arithmetic throughout -- no floating-point FFT, hence no
platform-dependent rounding (SURVEY.md "hard parts" #1).  Everything is
plain JAX; XLA fuses the elementwise stages and picks the GEMM kernel.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp

from .. import lwe
from . import decompose as dec
from . import poly, rotate

if TYPE_CHECKING:  # avoid circular import; CloudKey is only a type here
    from ..keys import CloudKey


def step_digits(p, acc: jax.Array, amt: jax.Array) -> jax.Array:
    """Rotate + difference + gadget decomposition of one CMUX step.

    acc: (B, k+1, N) int32; amt: (B,) int32 in [0, 2N).
    Returns (B, (k+1)*l*N) int8 digit rows, (poly, level, coefficient)-major
    -- the LHS of the step GEMM.
    """
    B = acc.shape[0]
    rot = rotate.negacyclic_rotate(acc, amt[:, None])  # over k+1 polys
    d = dec.decompose(rot - acc, p)                     # (B, k+1, N, l) int8
    return jnp.moveaxis(d, -1, -2).reshape(B, -1)


def cmux_step(p, acc: jax.Array, amt: jax.Array, w: jax.Array) -> jax.Array:
    """One CMUX step against the step's (C*N, G*N) int8 Toeplitz weights
    (transposed, as ops/poly.toeplitz_weights lays them out)."""
    d = step_digits(p, acc, amt)
    return acc + poly.extprod_w_i8(d, w, p.limb_plan, p.N)


def blind_rotate(ck: CloudKey, bara: jax.Array, barb: jax.Array, mu) -> jax.Array:
    """Batched blind rotation of the all-mu testvector.

    Args:
      ck: cloud key.
      bara: (B, n) int32 in [0, 2N) -- modswitched mask.
      barb: (B,) int32 in [0, 2N) -- modswitched body.
      mu: scalar torus32 testvector amplitude.

    Returns:
      (B, k+1, N) int32 accumulator  ~ TRLWE(X^{-phase2N} * tv).
    """
    p = ck.params
    B = bara.shape[0]
    tv = jnp.full((B, p.N), jnp.int32(mu))
    acc = jnp.concatenate(
        [jnp.zeros((B, p.k, p.N), jnp.int32),
         rotate.negacyclic_rotate(tv, (2 * p.N - barb) % (2 * p.N))[:, None, :]],
        axis=1,
    )

    if ck.bk_w is not None:   # the lattice's weights are precomputed
        keys_per_step, weights = ck.bk_w, lambda w: w
    else:
        keys_per_step, weights = ck.bk_tp, poly.toeplitz_weights

    def step(acc, xs):
        amt, key_i = xs
        return cmux_step(p, acc, amt, weights(key_i)), ()

    acc, _ = jax.lax.scan(step, acc, (bara.T, keys_per_step))
    return acc


def keyswitch_digits(p, a_ext: jax.Array) -> jax.Array:
    """Decompose extracted masks into base-2^basebit digit VALUES.

    a_ext: (B, kN) int32 -> (B, kN*t) int8 digits in [0, base).

    Value encoding instead of TFHE's per-digit table lookup: the ks table row
    for (i, j) is LWE(K_i * 2^shift_j), and the switched sample accumulates
    digit * row -- one (B, kN*t) x (kN*t, cols) int8 matmul, base-times less
    LHS traffic than a one-hot expansion.  Noise: sum of d*e with
    E[d^2] = (base-1)(2base-1)/6 vs the lookup's E = (base-1)/base * sigma^2
    -- x4.7 variance at base 4, well inside the decoding budget (see
    TfheParams.max_stdev analysis).
    """
    B, kn = a_ext.shape
    prec_offset = jnp.uint32(1 << (32 - (1 + p.ks_basebit * p.ks_t)))
    u = a_ext.astype(jnp.uint32) + prec_offset
    shifts = jnp.array([32 - (j + 1) * p.ks_basebit for j in range(p.ks_t)], jnp.uint32)
    digits = (u[..., None] >> shifts) & (p.ks_base - 1)  # (B, kN, t) uint32
    return digits.reshape(B, kn * p.ks_t).astype(jnp.int8)


def keyswitch(ck: CloudKey, a_ext: jax.Array, b_ext: jax.Array) -> lwe.Lwe:
    """Batched key switch kN -> n as a digit-valued int8 matmul.

    a_ext: (B, kN) int32, b_ext: (B,) int32 (extracted LWE under the big key).
    Returns Lwe under the small key, (B,).
    """
    p = ck.params
    B = a_ext.shape[0]
    digits = keyswitch_digits(p, a_ext)
    acc = jnp.dot(digits, ck.ks_table_limbs, preferred_element_type=jnp.int32)
    acc = poly.recombine_limbs_i32(acc.reshape(B, p.n + 1, 4), 4)  # (B, n+1)
    return lwe.Lwe(-acc[:, : p.n], b_ext - acc[:, p.n])


def bootstrap_wo_ks(ck: CloudKey, ct: lwe.Lwe, mu) -> "tuple[jax.Array, jax.Array]":
    """Bootstrap without the final key switch: returns extracted (a, b) pair.

    ct: Lwe (B,) under the small key; mu: torus32 amplitude.
    Output phase is +mu where phase(ct) in (0, 1/2), -mu where in (-1/2, 0).
    """
    p = ck.params
    bara = rotate.modswitch_2n(ct.a, p.N)
    barb = rotate.modswitch_2n(ct.b, p.N)
    acc = blind_rotate(ck, bara, barb, mu)
    from .. import tlwe  # local import to avoid cycle
    return tlwe.sample_extract(acc)


def bootstrap(ck: CloudKey, ct: lwe.Lwe, mu) -> lwe.Lwe:
    """Full gate bootstrap: LWE (B,) -> LWE (B,) with message +-mu by phase sign."""
    a_ext, b_ext = bootstrap_wo_ks(ck, ct, mu)
    return keyswitch(ck, a_ext, b_ext)
