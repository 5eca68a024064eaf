"""Bootstrapped Boolean gate API, batched.

Implements the exact contract of SURVEY.md section 2.3 -- the 8 gate symbols
the reference consumes (bootsAND/OR/XOR/XNOR/NOT/MUX/COPY/CONSTANT, e.g.
/root/reference/src/Math.cpp:34-43,260-261) plus the rest of TFHE's standard
gate set (NAND/NOR/ANDNY/ANDYN/ORNY/ORYN) for API completeness.  Every gate
broadcasts over arbitrary leading batch dims; each two-input gate costs one
batched bootstrap + keyswitch, MUX costs two bootstraps + one keyswitch, and
NOT/COPY/CONSTANT are free (no bootstrap), exactly like the reference
(SURVEY.md E5).

The "levelized batched schedule" abstraction (SURVEY.md section 7.6) is the
`lincomb_bootstrap` entry point: circuits stack heterogeneous same-depth gates
into ONE bootstrap launch by expressing each gate as a per-element linear
combination (wa*a + wb*b + offset) followed by the shared bootstrap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import lwe
from .keys import CloudKey
from .ops import bootstrap as bs
from .torus import modswitch_to_torus32

MU_1_8 = modswitch_to_torus32(1, 8)   # +1/8 torus32 == 2^29
MU_1_4 = modswitch_to_torus32(1, 4)   # +1/4


def _flatten(ct: lwe.Lwe):
    shape = ct.shape
    return lwe.Lwe(ct.a.reshape((-1, ct.dim)), ct.b.reshape(-1)), shape


def _unflatten(ct: lwe.Lwe, shape):
    return lwe.Lwe(ct.a.reshape(shape + (ct.dim,)), ct.b.reshape(shape))


def _bucket(n: int) -> int:
    """Round the flat batch up to a power of two (>= 8) so repeated bootstrap
    launches hit a bounded jit-compile cache instead of recompiling per shape."""
    b = 8
    while b < n:
        b *= 2
    return b


def _pad_flat(ct: lwe.Lwe, size: int) -> lwe.Lwe:
    n = ct.b.shape[0]
    if n == size:
        return ct
    return lwe.Lwe(
        jnp.pad(ct.a, ((0, size - n), (0, 0))),
        jnp.pad(ct.b, ((0, size - n),)),
    )


_jit_bootstrap = jax.jit(bs.bootstrap, static_argnames=())
_jit_bootstrap_wo_ks = jax.jit(bs.bootstrap_wo_ks)
_jit_keyswitch = jax.jit(bs.keyswitch)


# Eager-dispatch discipline: every level of a levelized circuit is driven
# from Python, so each stray jnp op between bootstrap launches is its own
# tiny device dispatch -- at thousands of launches per protocol run those
# add up.  The pre-combination (linear combo + flatten + pad) and post-slice
# therefore run as ONE jitted call each around the shared bucketed bootstrap
# executable; compiles are cheap (elementwise) and cached per shape.
@functools.partial(jax.jit, static_argnames=("bucket",))
def _pre_flat(a: lwe.Lwe, b: lwe.Lwe, wa, wb, offset, bucket: int) -> lwe.Lwe:
    pre = lwe.Lwe(
        a.a * wa[..., None] + b.a * wb[..., None],
        a.b * wa + b.b * wb + offset,
    )
    flat, _ = _flatten(pre)
    return _pad_flat(flat, bucket)


@functools.partial(jax.jit, static_argnames=("shape",))
def _post_unflat(out: lwe.Lwe, shape: tuple) -> lwe.Lwe:
    """Slice the padded flat batch back to the (static) gate batch shape."""
    n = 1
    for d in shape:
        n *= d
    return _unflatten(out[:n], shape)


def gate_bootstrap(ck: CloudKey, pre: lwe.Lwe) -> lwe.Lwe:
    """Bootstrap an arbitrary-shaped batch of prepared gate inputs to +-1/8."""
    flat, shape = _flatten(pre)
    n = flat.b.shape[0]
    out = _jit_bootstrap(ck, _pad_flat(flat, _bucket(n)), jnp.int32(MU_1_8))
    return _unflatten(out[:n], shape)


def lincomb_bootstrap(ck: CloudKey, a: lwe.Lwe, b: lwe.Lwe, wa, wb, offset) -> lwe.Lwe:
    """Generic two-input gate: bootstrap(wa*a + wb*b + (0, offset)).

    wa, wb: int arrays broadcastable to the gate batch shape; offset: torus32
    array likewise.  This is how heterogeneous same-level gates fuse into one
    bootstrap launch.
    """
    wa = jnp.asarray(wa, jnp.int32)
    wb = jnp.asarray(wb, jnp.int32)
    shape = jnp.broadcast_shapes(a.shape, b.shape, wa.shape)
    n = 1
    for d in shape:
        n *= d
    flat = _pre_flat(a, b, wa, wb, jnp.asarray(offset, jnp.int32),
                     bucket=_bucket(n))
    out = _jit_bootstrap(ck, flat, jnp.int32(MU_1_8))
    return _post_unflat(out, tuple(shape))


def AND(ck, a, b):   return lincomb_bootstrap(ck, a, b, 1, 1, -MU_1_8)
def OR(ck, a, b):    return lincomb_bootstrap(ck, a, b, 1, 1, MU_1_8)
def NAND(ck, a, b):  return lincomb_bootstrap(ck, a, b, -1, -1, MU_1_8)
def NOR(ck, a, b):   return lincomb_bootstrap(ck, a, b, -1, -1, -MU_1_8)
def XOR(ck, a, b):   return lincomb_bootstrap(ck, a, b, 2, 2, MU_1_4)
def XNOR(ck, a, b):  return lincomb_bootstrap(ck, a, b, -2, -2, -MU_1_4)
def ANDNY(ck, a, b): return lincomb_bootstrap(ck, a, b, -1, 1, -MU_1_8)  # (not a) and b
def ANDYN(ck, a, b): return lincomb_bootstrap(ck, a, b, 1, -1, -MU_1_8)  # a and (not b)
def ORNY(ck, a, b):  return lincomb_bootstrap(ck, a, b, -1, 1, MU_1_8)   # (not a) or b
def ORYN(ck, a, b):  return lincomb_bootstrap(ck, a, b, 1, -1, MU_1_8)   # a or (not b)


def NOT(ck, a: lwe.Lwe) -> lwe.Lwe:
    """Free negation (no bootstrap)."""
    return -a


def COPY(ck, a: lwe.Lwe) -> lwe.Lwe:
    """Free copy (no bootstrap)."""
    return a


def CONSTANT(ck: CloudKey, value, shape=()) -> lwe.Lwe:
    """Trivial ciphertext of a constant bit (bootsCONSTANT): no bootstrap.

    value: 0/1 (array broadcastable to `shape`).
    """
    v = jnp.broadcast_to(jnp.asarray(value, jnp.int32), shape)
    mu = jnp.where(v != 0, jnp.int32(MU_1_8), jnp.int32(-MU_1_8))
    return lwe.trivial(mu, ck.params.n, shape)


@functools.partial(jax.jit, static_argnames=("shape", "bucket"))
def _mux_pre(a: lwe.Lwe, b: lwe.Lwe, c: lwe.Lwe, shape: tuple, bucket: int) -> lwe.Lwe:
    a, b, c = (lwe.Lwe(jnp.broadcast_to(x.a, shape + (x.dim,)),
                       jnp.broadcast_to(x.b, shape)) for x in (a, b, c))
    pre1 = (a + b).add_const(-MU_1_8)       # ~ a AND b
    pre2 = (c - a).add_const(-MU_1_8)       # ~ (not a) AND c
    f1, _ = _flatten(pre1)
    f2, _ = _flatten(pre2)
    return _pad_flat(lwe.concatenate([f1, f2], axis=0), bucket)


@functools.partial(jax.jit, static_argnames=("n", "bucket"))
def _mux_mid(a_ext, b_ext, n: int, bucket: int):
    u_a = a_ext[:n] + a_ext[n : 2 * n]
    u_b = b_ext[:n] + b_ext[n : 2 * n] + jnp.int32(MU_1_8)
    return (jnp.pad(u_a, ((0, bucket - n), (0, 0))),
            jnp.pad(u_b, ((0, bucket - n),)))


def MUX(ck: CloudKey, a: lwe.Lwe, b: lwe.Lwe, c: lwe.Lwe) -> lwe.Lwe:
    """a ? b : c -- two bootstraps (no intermediate keyswitch) + one keyswitch.

    Like lincomb_bootstrap, the eager sections between the two bootstrap
    executables are folded into jitted helpers (one dispatch each)."""
    shape = jnp.broadcast_shapes(a.shape, b.shape, c.shape)
    B = 1
    for d in shape:
        B *= d
    both = _mux_pre(a, b, c, shape=tuple(shape), bucket=_bucket(2 * B))
    a_ext, b_ext = _jit_bootstrap_wo_ks(ck, both, jnp.int32(MU_1_8))
    u_a, u_b = _mux_mid(a_ext, b_ext, n=B, bucket=_bucket(B))
    out = _jit_keyswitch(ck, u_a, u_b)
    return _post_unflat(out, tuple(shape))


@functools.partial(jax.jit, static_argnames=("steps",))
def and_chain(ck: CloudKey, ct: lwe.Lwe, steps: int) -> lwe.Lwe:
    """`steps` serialized batched bootstraps AND(x, x) = x, each output
    feeding the next: the chained-gate workload of the benchmark and the
    noise campaign (a mid-chain decode error flips every later bit)."""
    def body(c, _):
        pre = lwe.Lwe(c.a * 2, c.b * 2 + jnp.int32(-MU_1_8))
        return bs.bootstrap(ck, pre, jnp.int32(MU_1_8)), ()
    out, _ = jax.lax.scan(body, ct, None, length=steps)
    return out


def encrypt_bits(key, sk, bits) -> lwe.Lwe:
    """bootsSymEncrypt, batched: bits (any shape of 0/1) -> Lwe of +-1/8."""
    bits = jnp.asarray(bits, jnp.int32)
    mu = jnp.where(bits != 0, jnp.int32(MU_1_8), jnp.int32(-MU_1_8))
    return lwe.encrypt(key, sk.lwe_key, mu, sk.params.lwe_stdev)


def decrypt_bits(ct: lwe.Lwe, sk) -> jax.Array:
    """bootsSymDecrypt, batched: sign of phase."""
    return lwe.decrypt_bit(ct, sk.lwe_key)
