"""LWE ciphertexts over torus32, batched.

Replaces the reference's pointer-soup ``LweSample*`` arrays (143 references,
SURVEY.md E3; allocated via new_gate_bootstrapping_ciphertext_array at e.g.
/root/reference/src/Math.cpp:28-30) with a single batched pytree: arbitrary
leading batch dims over a trailing mask dimension.  All linear homomorphic
ops are elementwise int32 with native mod-2^32 wrap.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp

from . import torus
from .params import TfheParams


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["a", "b"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class Lwe:
    """Batched LWE ciphertext(s): phase(c) = b - <a, s>  (mask convention: +).

    a: (..., dim) int32 mask
    b: (...,)    int32 body
    Encryption: b = <a, s> + mu + e, so phase = b - <a, s> = mu + e.
    """

    a: jax.Array
    b: jax.Array

    @property
    def dim(self) -> int:
        return self.a.shape[-1]

    @property
    def shape(self):
        return self.b.shape

    def __add__(self, other: "Lwe") -> "Lwe":
        return Lwe(self.a + other.a, self.b + other.b)

    def __sub__(self, other: "Lwe") -> "Lwe":
        return Lwe(self.a - other.a, self.b - other.b)

    def __neg__(self) -> "Lwe":
        return Lwe(-self.a, -self.b)

    def scale(self, c: int) -> "Lwe":
        return Lwe(self.a * jnp.int32(c), self.b * jnp.int32(c))

    def add_const(self, mu: Any) -> "Lwe":
        """Add a plaintext torus32 constant to the body."""
        return Lwe(self.a, self.b + jnp.int32(mu))

    def __getitem__(self, idx) -> "Lwe":
        # Indices address the batch dims (b's shape); `a` carries one extra
        # trailing mask dim, so append a full slice for it.  Works both for
        # front-anchored tuples and for indices containing Ellipsis.
        t = idx if isinstance(idx, tuple) else (idx,)
        return Lwe(self.a[t + (slice(None),)], self.b[idx])


def trivial(mu, dim: int, shape=()) -> Lwe:
    """Noiseless trivial ciphertext (a=0, b=mu) -- TFHE's bootsCONSTANT core."""
    mu = jnp.broadcast_to(jnp.asarray(mu, jnp.int32), shape)
    return Lwe(jnp.zeros(shape + (dim,), jnp.int32), mu)


def encrypt(key: jax.Array, sk: jax.Array, mu: jax.Array, stdev: float) -> Lwe:
    """Encrypt torus32 message(s) under binary key sk (dim,), batched over mu."""
    from .ops import poly  # local import to avoid cycle

    mu = jnp.asarray(mu, jnp.int32)
    dim = sk.shape[-1]
    ka, ke = jax.random.split(key)
    a = torus.uniform_torus32(ka, mu.shape + (dim,))
    e = torus.gaussian_torus32(ke, stdev, mu.shape)
    b = poly.dot_key_i32(a, sk) + mu + e
    return Lwe(a, b.astype(jnp.int32))


def phase(ct: Lwe, sk: jax.Array) -> jax.Array:
    """Decryption phase b - <a, s> (torus32)."""
    from .ops import poly

    return ct.b - poly.dot_key_i32(ct.a, sk)


def decrypt_bit(ct: Lwe, sk: jax.Array) -> jax.Array:
    """Gate-bootstrapping bit decryption: sign of the phase (bootsSymDecrypt)."""
    return (phase(ct, sk) > 0).astype(jnp.int32)


def _a_axis(axis: int) -> int:
    """Batch-dim axis for the mask tensor (extra trailing mask dim)."""
    return axis if axis >= 0 else axis - 1


def stack(cts, axis=0) -> Lwe:
    return Lwe(
        jnp.stack([c.a for c in cts], axis=_a_axis(axis)),
        jnp.stack([c.b for c in cts], axis=axis),
    )


def concatenate(cts, axis=0) -> Lwe:
    return Lwe(
        jnp.concatenate([c.a for c in cts], axis=_a_axis(axis)),
        jnp.concatenate([c.b for c in cts], axis=axis),
    )


def where(pred: jax.Array, x: Lwe, y: Lwe) -> Lwe:
    return Lwe(jnp.where(pred[..., None], x.a, y.a), jnp.where(pred, x.b, y.b))
