"""Negacyclic polynomial arithmetic in Z[X]/(X^N + 1) over torus32.

This module replaces the reference's external FFT processor (the
"nayuki-portable" double-precision FFT inside libtfhe, SURVEY.md E8) with
exact-integer paths:

1. ``negacyclic_mul_naive`` -- O(N^2) int32 schoolbook product with native
   mod-2^32 wrap-around.  Bit-exact by construction; the test oracle.

2. ``extprod_toeplitz_i8`` -- the external product: the small operand
   (gadget digits, |d| <= Bg/2 <= 128, int8) multiplies the torus32 operand
   split into balanced signed 8-bit limbs, laid out as a negacyclic-Toeplitz
   weight matrix, in ONE s8 x s8 -> s32 matmul.  Exactness: each output
   coefficient accumulates at most G*N terms of |digit|*|limb| <=
   (k+1)*l*N*128*128 < 2^31, so the int32 accumulator never overflows; the
   limb recombination then wraps mod 2^32, which is exactly torus arithmetic.

Unlike the reference's per-gate scalar FFTs (one libtfhe call per gate,
/root/reference/src/Math.cpp:27-50), everything here is batched over a leading
ciphertext-batch dimension.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def negacyclic_matrix(q: jax.Array) -> jax.Array:
    """Build the negacyclic (anti-circulant) matrix M with (p @ M) = p*q mod X^N+1.

    M[t, j] = q[(j - t) mod N] * (-1 if j < t else 1).
    """
    N = q.shape[-1]
    j = jnp.arange(N)[None, :]
    t = jnp.arange(N)[:, None]
    idx = (j - t) % N
    sign = jnp.where(j >= t, 1, -1).astype(q.dtype)
    return q[..., idx] * sign


def negacyclic_mul_naive(p: jax.Array, q: jax.Array) -> jax.Array:
    """Exact negacyclic product mod 2^32; p, q int32, broadcast leading dims."""
    p = jnp.asarray(p, jnp.int32)
    m = negacyclic_matrix(jnp.asarray(q, jnp.int32))
    # int32 matmul with wrap-around: correct but slow -- the oracle path only.
    return jnp.einsum("...t,...tj->...j", p, m)


def round_to_limbs(x: jax.Array, limbs: int) -> jax.Array:
    """Round torus32 to the top `limbs` bytes (the canonical truncated value
    that split_limbs_i8(x, limbs) represents); identity when limbs == 4."""
    x = jnp.asarray(x, jnp.int32)
    if limbs >= 4:
        return x
    drop = 8 * (4 - limbs)
    return jnp.bitwise_and(x + (1 << (drop - 1)), np.int32(-1 << drop))


def split_limbs_i8(x: jax.Array, limbs: int = 4) -> jax.Array:
    """Split int32 into `limbs` balanced signed 8-bit limbs (axis appended last).

    x == sum_m out[..., m] * 2^(8m)  (mod 2^32, exact when limbs == 4; when
    limbs < 4 the value is rounded to the top `limbs` bytes, adding a
    symmetric error < 2^(8*(4-limbs)-1)).
    Each limb is in [-128, 127].
    """
    x = jnp.asarray(x, jnp.int32)
    if limbs < 4:
        drop = 8 * (4 - limbs)
        # Symmetric rounding to avoid bias: add half-ulp before truncation.
        x = x + (1 << (drop - 1))
        x = jnp.bitwise_and(x, np.int32(-1 << drop))
    out = []
    r = x >> (8 * (4 - limbs)) if limbs < 4 else x
    for _ in range(limbs):
        limb = ((r + 128) & 255) - 128  # balanced residue in [-128, 127]
        out.append(limb.astype(jnp.int8))
        r = (r - limb) >> 8  # arithmetic shift; exact since r - limb is mult of 256
    return jnp.stack(out, axis=-1)


def recombine_limbs_i32(parts: jax.Array, limbs: int) -> jax.Array:
    """Inverse of split_limbs_i8 over the last axis; wraps mod 2^32.

    parts: (..., limbs) int32 per-limb partial products -> (...,) int32.
    When limbs < 4 the result is scaled back up by 2^(8*(4-limbs)).
    """
    shift0 = 8 * (4 - limbs)
    acc = jnp.zeros(parts.shape[:-1], jnp.int32)
    for m in range(limbs):
        acc = acc + (parts[..., m].astype(jnp.int32) << (shift0 + 8 * m))
    return acc


def as_limb_plan(limbs, n_out: int) -> "tuple[int, ...]":
    """Normalize an int or per-output tuple into a limb plan of length n_out."""
    if isinstance(limbs, int):
        return (limbs,) * n_out
    plan = tuple(limbs)
    assert len(plan) == n_out, (plan, n_out)
    return plan


def recombine_plan_i32(cols: jax.Array, plan: "tuple[int, ...]") -> jax.Array:
    """Recombine per-(output, limb) columns into O torus32 outputs.

    cols: (B, C, N) int32 with C = sum(plan), columns ordered output-major
    (output o's plan[o] limbs contiguous, low limb first) -> (B, O, N).
    """
    outs = []
    c0 = 0
    for nl in plan:
        shift0 = 8 * (4 - nl)
        acc = jnp.zeros(cols.shape[:1] + cols.shape[2:], jnp.int32)
        for m in range(nl):
            acc = acc + (cols[:, c0 + m] << (shift0 + 8 * m))
        outs.append(acc)
        c0 += nl
    return jnp.stack(outs, axis=1)


def toeplitz_weights(vv_limbs: jax.Array, j0=0, nj: int | None = None) -> jax.Array:
    """A step's GEMM weights from its doubled limb generator, transposed.

    vv_limbs: (G, C, 2N) int8 (from `prepare_toeplitz_rhs`) -> (C*nj, G*N)
    int8 W^T with W^T[c*nj + dj, g*N + t] = vv[g, c, N - t + j0 + dj] =
    (X^t * q_limb[g, c])[j0 + dj]: output coefficients [j0, j0 + nj) (all N
    by default; j0 may be traced, 0 <= j0 <= N - nj).  Both GEMM operands
    then keep the contraction axis minor, the layout int8 tensor-core GEMMs
    take without a transpose.

    Built with slices, tile and reshape only: with ru the reversed window
    vv[j0 : j0 + N + nj], row dj of each (dj, t) block is ru[nj-1-dj+t], and
    tiling ru then reshaping to rows one element shorter lays those skewed
    windows out without a gather.
    """
    G, C, n2 = vv_limbs.shape
    N = n2 // 2
    nj = N if nj is None else nj
    L = N + nj
    ru = jax.lax.dynamic_slice_in_dim(vv_limbs, j0, L, axis=-1)[..., ::-1]
    skew = jnp.tile(ru, (1, 1, nj))[..., : nj * (L - 1)]
    blocks = skew.reshape(G, C, nj, L - 1)[..., nj - 1: nj - 1 + N]
    return jnp.transpose(blocks, (1, 2, 0, 3)).reshape(C * nj, G * N)


def extprod_w_i8(digits: jax.Array, w_t: jax.Array, plan, N: int) -> jax.Array:
    """External product against prepared weights: one s8 x s8 -> s32 GEMM,
    then limb recombination.

    digits: (B, G*N) int8; w_t: (C*N, G*N) int8 (`toeplitz_weights`); plan:
    per-output limb counts summing to C.  Returns (B, O, N) int32 mod 2^32.
    """
    B = digits.shape[0]
    out = jax.lax.dot_general(digits, w_t, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return recombine_plan_i32(out.reshape(B, -1, N), plan)


def extprod_toeplitz_i8(digits: jax.Array, vv_limbs: jax.Array, limbs) -> jax.Array:
    """External product via explicit negacyclic-Toeplitz int8 matmul.

    digits: (B, G, N) int8; vv_limbs: (G, C, 2N) int8 (doubled limb-split
    TRGSW row polys, from `prepare_toeplitz_rhs`; C = sum(limb plan)).
    Returns (B, O, N) int32 mod 2^32 -- the exact negacyclic product
    (`negacyclic_extproduct_reference`) of the limb-rounded operand.
    """
    B, G, N = digits.shape
    C = vv_limbs.shape[1]
    plan = limbs if isinstance(limbs, tuple) else as_limb_plan(limbs, C // limbs)
    return extprod_w_i8(digits.reshape(B, G * N), toeplitz_weights(vv_limbs),
                        plan, N)


def prepare_toeplitz_rhs(q: jax.Array, limbs) -> jax.Array:
    """Precompute the doubled limb-split generator for `extprod_toeplitz_i8`.

    q: (G, O, N) int32 -> (G, C, 2N) int8; C = sum(limb plan), columns
    output-major, low limb first.

    NB: the negated half is limb-split from -q (int32) rather than negating
    the limbs of q: balanced limbs hit -128, whose int8 negation overflows.
    Recombination is linear, so mixing limbs-of(-q) in the wrap region with
    limbs-of(q) elsewhere reconstructs the exact signed Toeplitz.
    """
    G, O, N = q.shape
    plan = as_limb_plan(limbs, O)
    cols = []
    for o, nl in enumerate(plan):
        # Round ONCE to the canonical nl-byte value, then split +-q_r (both
        # exactly representable).  Splitting -q and q independently would
        # round ties (low byte 0x80) in opposite directions, making the two
        # Toeplitz halves encode different polynomials.
        q_r = round_to_limbs(q[:, o], nl)
        neg = split_limbs_i8(-q_r, nl)                 # (G, N, nl)
        pos = split_limbs_i8(q_r, nl)
        vv = jnp.concatenate([neg, pos], axis=-2)      # (G, 2N, nl)
        cols.append(jnp.moveaxis(vv, -1, 1))           # (G, nl, 2N)
    return jnp.concatenate(cols, axis=1)               # (G, C, 2N)


def extprod_toeplitz_cols_i8(digits: jax.Array, vv_limbs: jax.Array, limbs,
                             j0: jax.Array, nj: int) -> jax.Array:
    """Column slice [j0, j0+nj) of the external product `extprod_toeplitz_i8`.

    digits: (B, G, N) int8; vv_limbs: (G, C, 2N) int8; j0 traced, nj static.
    Returns (B, O, nj) int32 == extprod_toeplitz_i8(...)[..., j0:j0+nj]
    bit-for-bit: the output coefficient axis is embarrassingly column-
    parallel (each j is an independent dot against the digit rows), so a tp
    rank computing only its slice and all_gathering matches the replicated
    product exactly.  This is the ring-dimension tensor-parallel building
    block: each rank assembles only its slice of every step's weights from
    the small replicated generator (SURVEY.md section 2.4).
    """
    B, G, N = digits.shape
    C = vv_limbs.shape[1]
    plan = limbs if isinstance(limbs, tuple) else as_limb_plan(limbs, C // limbs)
    return extprod_w_i8(digits.reshape(B, G * N),
                        toeplitz_weights(vv_limbs, j0, nj), plan, nj)


def prepare_w_full(vv_limbs: jax.Array) -> jax.Array:
    """Every step's `toeplitz_weights`, precomputed: (n, G, C, 2N) int8 ->
    (n, C*N, G*N) int8, built 16 steps at a time into one buffer so the
    build's intermediates stay small next to the output."""
    n, G, C, n2 = vv_limbs.shape
    N = n2 // 2
    out = jnp.zeros((n, C * N, G * N), jnp.int8)
    for s0 in range(0, n, 16):
        w = jax.vmap(toeplitz_weights)(vv_limbs[s0:s0 + 16])
        out = jax.lax.dynamic_update_slice_in_dim(out, w, s0, 0)
    return out


def key_negacyclic_mul(key_bits: jax.Array, a: jax.Array) -> jax.Array:
    """sum_u key_u * a_u mod X^N+1, exact, as one int8 Toeplitz matmul.

    key_bits: (k, N) 0/1; a: (..., k, N) torus32.  Returns (..., N) int32.
    Used on the keygen/encryption side (TRLWE bodies): the torus32 operand
    limb-splits into int8 rows, the binary key becomes the (k*N, N)
    negacyclic matrix with entries in {-1, 0, 1}.
    Accumulation bound: k*N*128 < 2^31.
    """
    k, N = key_bits.shape
    batch = a.shape[:-2]
    al = split_limbs_i8(a, 4)                      # (..., k, N, 4)
    al = jnp.moveaxis(al, -1, -3)                  # (..., 4, k, N)
    m = negacyclic_matrix(jnp.asarray(key_bits, jnp.int8))  # (k, N_t, N_j)
    c = jnp.dot(al.reshape(-1, k * N), m.reshape(k * N, N),
                preferred_element_type=jnp.int32)  # (B*4, N)
    c = c.reshape(batch + (4, N))
    return recombine_limbs_i32(jnp.moveaxis(c, -2, -1), 4)


def dot_key_i32(a: jax.Array, key_bits: jax.Array) -> jax.Array:
    """Exact <a, key> mod 2^32 for binary key: (..., n) int32 x (n,) -> (...,).

    Limb-splits `a` to int8 so the contraction runs as an int8 matmul;
    bound n*128 < 2^31.
    """
    n = key_bits.shape[-1]
    al = split_limbs_i8(a, 4)                      # (..., n, 4)
    al = jnp.moveaxis(al, -1, -2)                  # (..., 4, n)
    out = jnp.einsum("...ln,n->...l", al, jnp.asarray(key_bits, jnp.int8),
                     preferred_element_type=jnp.int32)
    return recombine_limbs_i32(out, 4)


def negacyclic_extproduct_reference(digits: jax.Array, q: jax.Array) -> jax.Array:
    """Oracle: (B, G, N) int32 digits x (G, O, N) int32 -> (B, O, N) int32."""
    m = negacyclic_matrix(q)  # (G, O, N, N)
    return jnp.einsum("bgt,gotj->boj", jnp.asarray(digits, jnp.int32), m)
