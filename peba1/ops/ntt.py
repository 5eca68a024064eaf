"""Exact integer negacyclic NTT -- a prototype kept as plain JAX.

The reference's polynomial engine is a floating-point FFT
(/root/reference/CMakeLists.txt:11 links the TFHE FFT processors;
README.md:16).  SURVEY.md section 7 step 2 named an exact NTT as the
potential speed-of-light kernel; the shipped engine is instead the O(N^2)
int8 Toeplitz GEMM (ops/poly.py), which runs on the int8 tensor cores.  This
module is a working, bit-exact negacyclic NTT, so that choice can be
measured rather than assumed; it is not on the bootstrap path, and no
measurement of it against the GEMM has been made on the GPU yet.

Arithmetic: prime field p = 754974721 = 45 * 2^24 + 1 (NTT-friendly: 2^24 |
p-1, so 2N-th roots exist for every shipped ring size), primitive root g=11.
Every multiplication is by a PRECOMPUTED constant (stage twiddles, twist
factors, pointwise key values in a full external-product use), so Shoup's
precomputed-quotient modmul applies throughout:

    q = umulhi(w_shoup, x);  r = w*x - q*p  (all uint32 lowmul);  r -= p if r >= p

with umulhi emulated from 16-bit halves (portable jnp has no 32x32->hi
primitive; 4 lowmuls + ~10 adds/shifts).  That makes one modmul ~6 lowmuls +
~12 cheap elementwise ops.

Exactness contract: `negacyclic_mul_exact(a, b)` returns the true integer
negacyclic convolution (signed) PROVIDED every output coefficient satisfies
|c| < p/2 ~ 2^28.2.  The external product's per-limb-column products (int8
digits x int8 key limbs, N <= 2048) are bounded by N * 127 * 128 < 2^25, so
the engine's exact-integer semantics are reproducible on this path
bit-for-bit -- asserted against ops/poly.negacyclic_mul_naive in
tests/test_ntt.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

P = 754974721            # 45 * 2^24 + 1
G = 11                   # primitive root of P


def _pow_mod(b: int, e: int, m: int = P) -> int:
    return pow(b, e, m)


@functools.lru_cache(maxsize=None)
def _tables(N: int):
    """Host-side precompute: bit-reversal permutation, per-stage twiddles
    (value + Shoup quotient), negacyclic twist factors, inverse variants."""
    assert N & (N - 1) == 0 and (P - 1) % (2 * N) == 0
    logn = N.bit_length() - 1
    # bit reversal
    rev = np.zeros(N, np.int32)
    for i in range(N):
        rev[i] = int(bin(i + N)[3:][::-1], 2)
    w = _pow_mod(G, (P - 1) // N)          # primitive N-th root
    wi = _pow_mod(w, P - 2)
    psi = _pow_mod(G, (P - 1) // (2 * N))  # primitive 2N-th root (twist)
    psii = _pow_mod(psi, P - 2)
    ninv = _pow_mod(N, P - 2)

    def shoup(vals):
        vals = np.asarray(vals, np.uint64)
        return (vals.astype(np.uint32),
                ((vals << np.uint64(32)) // np.uint64(P)).astype(np.uint32))

    stages, stages_i = [], []
    for s in range(1, logn + 1):
        m, half = 1 << s, 1 << (s - 1)
        wm = _pow_mod(w, N // m)
        wmi = _pow_mod(wi, N // m)
        stages.append(shoup([_pow_mod(wm, j) for j in range(half)]))
        stages_i.append(shoup([_pow_mod(wmi, j) for j in range(half)]))
    twist = shoup([_pow_mod(psi, j) for j in range(N)])
    # inverse twist folds in N^-1: x_j *= psi^-j * N^-1
    twist_i = shoup([(_pow_mod(psii, j) * ninv) % P for j in range(N)])
    return rev, stages, stages_i, twist, twist_i


def _umulhi(a: jax.Array, b: jax.Array) -> jax.Array:
    """High 32 bits of a*b for uint32 operands, via 16-bit halves (jnp has
    no widening multiply).  ~4 lowmuls + ~10 adds/shifts."""
    m = jnp.uint32(0xFFFF)
    a0, a1 = a & m, a >> 16
    b0, b1 = b & m, b >> 16
    t = a0 * b0
    mid = a1 * b0 + (t >> 16)
    mid2 = a0 * b1 + (mid & m)
    return a1 * b1 + (mid >> 16) + (mid2 >> 16)


def _mulmod_shoup(x: jax.Array, w: jax.Array, w_sh: jax.Array) -> jax.Array:
    """x * w mod P with precomputed w_sh = floor(w * 2^32 / P).  x < P."""
    q = _umulhi(w_sh, x)
    r = w * x - q * jnp.uint32(P)          # in [0, 2P)
    return jnp.where(r >= P, r - jnp.uint32(P), r)


def _addmod(a, b):
    s = a + b
    return jnp.where(s >= P, s - jnp.uint32(P), s)


def _submod(a, b):
    return jnp.where(a >= b, a - b, a + jnp.uint32(P) - b)


def _cyclic_ntt(x: jax.Array, stages, rev) -> jax.Array:
    """Iterative Cooley-Tukey over the last axis; x uint32 residues."""
    N = x.shape[-1]
    x = jnp.take(x, jnp.asarray(rev), axis=-1)
    for (wv, ws) in stages:
        half = wv.shape[0]
        m = 2 * half
        shp = x.shape[:-1] + (N // m, m)
        xr = x.reshape(shp)
        u = xr[..., :half]
        v = _mulmod_shoup(xr[..., half:], jnp.asarray(wv), jnp.asarray(ws))
        x = jnp.concatenate([_addmod(u, v), _submod(u, v)], axis=-1)
        x = x.reshape(x.shape[:-2] + (N,))
    return x


def _to_residue(x: jax.Array) -> jax.Array:
    """Signed int32 -> uint32 residue mod P (|x| < P/2 assumed)."""
    x = jnp.asarray(x, jnp.int32)
    return jnp.where(x < 0, x + jnp.int32(P), x).astype(jnp.uint32)


def _from_residue(r: jax.Array) -> jax.Array:
    """uint32 residue -> signed int32 centered representative."""
    half = jnp.uint32(P // 2)
    return jnp.where(r > half, r.astype(jnp.int64) - P,
                     r.astype(jnp.int64)).astype(jnp.int32)


def ntt_negacyclic(x: jax.Array) -> jax.Array:
    """Forward negacyclic NTT of signed int32 coefficients (last axis)."""
    N = x.shape[-1]
    rev, stages, _, twist, _ = _tables(N)
    r = _to_residue(x)
    r = _mulmod_shoup(r, jnp.asarray(twist[0]), jnp.asarray(twist[1]))
    return _cyclic_ntt(r, stages, rev)


def intt_negacyclic(X: jax.Array) -> jax.Array:
    """Inverse of ntt_negacyclic: uint32 eval-domain -> signed int32 coeffs."""
    N = X.shape[-1]
    rev, _, stages_i, _, twist_i = _tables(N)
    r = _cyclic_ntt(X, stages_i, rev)
    r = _mulmod_shoup(r, jnp.asarray(twist_i[0]), jnp.asarray(twist_i[1]))
    return _from_residue(r)


def negacyclic_mul_exact(a: jax.Array, b: jax.Array) -> jax.Array:
    """Exact signed negacyclic convolution via NTT, valid while every output
    coefficient is < P/2 in magnitude (true for int8-digit x int8-limb
    products at N <= 2048: bound N*127*128 < 2^25 << 2^28).

    Note the pointwise stage here multiplies two DATA transforms, so it uses
    a Barrett-style reduction via _umulhi on both operands (in the real
    external-product deployment the key side is precomputed -> Shoup).
    """
    A = ntt_negacyclic(a)
    B = ntt_negacyclic(b)
    # generic modmul (neither side precomputed): split b and reduce
    # a*b = a*(b1*2^16 + b0); reduce a*b1 mod P via Shoup-by-2^16 twice.
    C = _mulmod_generic(A, B)
    return intt_negacyclic(C)


_SH16 = (np.uint32(1 << 16), np.uint32(((1 << 16) << 32) // P))


def _mulmod_generic(a: jax.Array, b: jax.Array) -> jax.Array:
    """a * b mod P for two uint32 residue arrays (no precomputed quotient):
    16-bit split of b + two Shoup multiplies by the constant 2^16."""
    m = jnp.uint32(0xFFFF)
    b0, b1 = b & m, b >> 16
    # a*b1 mod P: both < P and < 2^16 resp -> product < 2^46; do via
    # (a*b1 low-bits are not enough) -- use umulhi composition:
    hi1 = _umulhi(a, b1)
    lo1 = a * b1
    r1 = _reduce64(hi1, lo1)
    r1 = _mulmod_shoup(r1, jnp.asarray(_SH16[0]), jnp.asarray(_SH16[1]))
    hi0 = _umulhi(a, b0)
    lo0 = a * b0
    r0 = _reduce64(hi0, lo0)
    return _addmod(r1, r0)


def _reduce64(hi: jax.Array, lo: jax.Array) -> jax.Array:
    """(hi*2^32 + lo) mod P via Shoup multiply of hi by (2^32 mod P)."""
    c = np.uint64((1 << 32) % P)
    cv = np.uint32(c)
    cs = np.uint32((c << np.uint64(32)) // np.uint64(P))
    # hi < 2^32; hi mod P first (one conditional subtract loop unrolled:
    # hi < 2^32 < 6P, so up to 5 subtracts -- do it arithmetically)
    hi = hi - (hi // jnp.uint32(P)) * jnp.uint32(P)
    t = _mulmod_shoup(hi, jnp.asarray(cv), jnp.asarray(cs))
    lo_r = lo - (lo // jnp.uint32(P)) * jnp.uint32(P)
    return _addmod(t, lo_r)
