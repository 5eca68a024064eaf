"""Core crypto layer tests: torus, poly, decomposition, LWE/TRLWE/TRGSW.

Test strategy stolen from the reference (SURVEY.md section 4): every layer has
a cleartext oracle; random inputs under fixed PRNG keys; round-trip gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from peba1 import keys, lwe, tlwe, torus
from peba1.ops import decompose as dec
from peba1.ops import poly, rotate
from peba1.params import TOY, TOY_NOISY


# ---------------------------------------------------------------- torus


def test_modswitch_to_torus32():
    assert torus.modswitch_to_torus32(1, 8) == 2**29
    assert torus.modswitch_to_torus32(-1, 8) == -(2**29)
    assert torus.modswitch_to_torus32(1, 4) == 2**30
    assert torus.modswitch_to_torus32(0, 8) == 0


def test_gaussian_zero_stdev():
    g = torus.gaussian_torus32(jax.random.PRNGKey(0), 0.0, (16,))
    assert (np.asarray(g) == 0).all()


# ---------------------------------------------------------------- poly


def _np_negacyclic(p, q):
    N = len(p)
    out = np.zeros(N, np.int64)
    for t in range(N):
        for u in range(N):
            s = t + u
            if s < N:
                out[s] += int(p[t]) * int(q[u])
            else:
                out[s - N] -= int(p[t]) * int(q[u])
    return out.astype(np.uint64).astype(np.uint32).astype(np.int32)


def test_negacyclic_mul_naive_matches_numpy():
    rng = np.random.default_rng(0)
    N = 16
    p = rng.integers(-(2**31), 2**31, N, dtype=np.int64).astype(np.int32)
    q = rng.integers(-(2**31), 2**31, N, dtype=np.int64).astype(np.int32)
    got = np.asarray(poly.negacyclic_mul_naive(p, q))
    np.testing.assert_array_equal(got, _np_negacyclic(p, q))


def test_limb_split_roundtrip():
    rng = np.random.default_rng(1)
    x = rng.integers(-(2**31), 2**31, (64,), dtype=np.int64).astype(np.int32)
    l = poly.split_limbs_i8(jnp.asarray(x), 4)
    back = poly.recombine_limbs_i32(l.astype(jnp.int32), 4)
    np.testing.assert_array_equal(np.asarray(back), x)


def test_limb_split_3_rounds():
    x = jnp.asarray([0, 255, 256, -129, 2**30, -(2**30)], jnp.int32)
    l = poly.split_limbs_i8(x, 3)
    back = np.asarray(poly.recombine_limbs_i32(l.astype(jnp.int32), 3))
    err = (back.astype(np.int64) - np.asarray(x, np.int64))
    assert np.abs(err).max() <= 128


@pytest.mark.parametrize("k,N", [(1, 16), (2, 32), (1, 128), (2, 128)])
def test_key_negacyclic_mul_matches_naive(k, N):
    """The int8 Toeplitz-matmul key product (TRLWE encryption, keygen) must
    equal the exact int32 schoolbook product summed over the k key polys."""
    rng = np.random.default_rng(2 + k + N)
    key = rng.integers(0, 2, (k, N)).astype(np.int32)
    a = rng.integers(-(2**31), 2**31, (3, k, N), dtype=np.int64).astype(np.int32)
    want = sum(np.asarray(poly.negacyclic_mul_naive(a[:, u], key[u]))
               for u in range(k))
    got = np.asarray(poly.key_negacyclic_mul(jnp.asarray(key), jnp.asarray(a)))
    np.testing.assert_array_equal(got, want.astype(np.int32))


# ---------------------------------------------------------------- rotate


def test_negacyclic_rotate_matches_naive():
    rng = np.random.default_rng(3)
    N = 32
    x = rng.integers(-(2**31), 2**31, (5, N), dtype=np.int64).astype(np.int32)
    amt = rng.integers(0, 2 * N, (5,))
    got = np.asarray(rotate.negacyclic_rotate(jnp.asarray(x), jnp.asarray(amt, jnp.int32)))
    for b in range(5):
        # X^amt * p: coefficient j of result = +-p[(j - amt) mod N]
        want = np.zeros(N, np.int32)
        for t in range(N):
            j = (t + amt[b]) % (2 * N)
            if j < N:
                want[j] += x[b, t]
            else:
                want[j - N] -= x[b, t]
        np.testing.assert_array_equal(got[b], want)


# ---------------------------------------------------------------- decompose


def test_decompose_zero_is_zero():
    d = dec.decompose(jnp.zeros((8,), jnp.int32), TOY)
    assert (np.asarray(d) == 0).all()


def test_decompose_recompose_precision():
    rng = np.random.default_rng(4)
    x = rng.integers(-(2**31), 2**31, (256,), dtype=np.int64).astype(np.int32)
    d = dec.decompose(jnp.asarray(x), TOY)
    assert np.asarray(d).min() >= -TOY.half_bg and np.asarray(d).max() < TOY.half_bg
    back = np.asarray(dec.recompose(d, TOY)).astype(np.int64)
    err = (back - x.astype(np.int64)) % (1 << 32)
    err = np.minimum(err, (1 << 32) - err)
    # Reconstruction truncates the low 32 - l*bgbit bits of (t + offset):
    # one-sided error strictly below one last-digit ulp.
    assert err.max() < 1 << (32 - TOY.l * TOY.bgbit)


# ---------------------------------------------------------------- LWE / TRLWE


def test_lwe_roundtrip_noiseless(toy_keys):
    sk, _ = toy_keys
    mu = jnp.asarray([2**29, -(2**29), 123456, 0], jnp.int32)
    ct = lwe.encrypt(jax.random.PRNGKey(7), sk.lwe_key, mu, 0.0)
    np.testing.assert_array_equal(np.asarray(lwe.phase(ct, sk.lwe_key)), np.asarray(mu))


def test_lwe_roundtrip_noisy(rng):
    sk, _ = keys.keygen(rng, TOY_NOISY)
    mu = jnp.full((128,), 2**29, jnp.int32)
    ct = lwe.encrypt(jax.random.PRNGKey(8), sk.lwe_key, mu, TOY_NOISY.lwe_stdev)
    ph = np.asarray(lwe.phase(ct, sk.lwe_key)).astype(np.int64)
    err = ph - 2**29
    assert np.abs(err).max() < 2**22  # ~ 6 sigma at 2^-15 stdev
    assert np.abs(err).max() > 0     # noise actually present


def test_trlwe_roundtrip(toy_keys):
    sk, _ = toy_keys
    mu = jnp.arange(TOY.N, dtype=jnp.int32) * 65537
    ct = tlwe.encrypt(jax.random.PRNGKey(9), sk.tlwe_key, mu, TOY)
    np.testing.assert_array_equal(np.asarray(tlwe.phase(ct, sk.tlwe_key)), np.asarray(mu))


def test_sample_extract_consistency(toy_keys):
    sk, _ = toy_keys
    mu = jnp.arange(TOY.N, dtype=jnp.int32) * 31337
    ct = tlwe.encrypt(jax.random.PRNGKey(10), sk.tlwe_key, mu, TOY)
    a_ext, b_ext = tlwe.sample_extract(ct)
    ph = b_ext - jnp.einsum("d,d->", a_ext, sk.extracted_key)
    assert int(ph) == int(mu[0])


def test_trgsw_external_product(toy_keys):
    """ext_product(TRLWE(m), TRGSW(bit)) ~ TRLWE(bit * m)."""
    import functools
    sk, _ = toy_keys
    mu = (jnp.arange(TOY.N, dtype=jnp.int32) % 7 - 3) << 26
    ct = tlwe.encrypt(jax.random.PRNGKey(11), sk.tlwe_key, mu, TOY)
    dfn = functools.partial(dec.decompose, params=TOY)
    for bit in (0, 1):
        g = tlwe.trgsw_encrypt(jax.random.PRNGKey(12), sk.tlwe_key, jnp.int32(bit), TOY)
        prod = tlwe.external_product_reference(dfn, ct[None], g, TOY)[0]
        ph = np.asarray(tlwe.phase(prod, sk.tlwe_key)).astype(np.int64)
        want = bit * np.asarray(mu).astype(np.int64)
        err = (ph - want) % (1 << 32)
        err = np.minimum(err, (1 << 32) - err)
        # error bounded by decomposition precision * N * digits
        assert err.max() < 2 ** (32 - TOY.l * TOY.bgbit) * TOY.N * (TOY.k + 1) * TOY.l


def test_toeplitz_backend_matches_reference():
    """extprod_toeplitz_i8 must equal the exact int32 negacyclic product,
    including the -128-limb edge case (split of -q, not negated limbs)."""
    rng = np.random.default_rng(8)
    B, G, O, N, L = 3, 6, 2, 256, 4
    digits = jnp.asarray(rng.integers(-64, 64, (B, G, N), dtype=np.int64).astype(np.int8))
    q = rng.integers(-(2**31), 2**31, (G, O, N), dtype=np.int64).astype(np.int32)
    # force some -128 limbs deterministically
    q[0, 0, :4] = np.int32(-128 & 0xFF | 0x80000000 - 2**31)  # low byte 0x80
    q = jnp.asarray(q)
    want = np.asarray(poly.negacyclic_extproduct_reference(digits, q))
    got = np.asarray(poly.extprod_toeplitz_i8(digits, poly.prepare_toeplitz_rhs(q, L), L))
    np.testing.assert_array_equal(got, want)


def test_toeplitz_3limb_error_bound():
    rng = np.random.default_rng(9)
    B, G, O, N = 2, 6, 2, 128
    digits = jnp.asarray(rng.integers(-64, 64, (B, G, N), dtype=np.int64).astype(np.int8))
    q = jnp.asarray(rng.integers(-(2**31), 2**31, (G, O, N), dtype=np.int64).astype(np.int32))
    want = np.asarray(poly.negacyclic_extproduct_reference(digits, q)).astype(np.int64)
    got = np.asarray(poly.extprod_toeplitz_i8(digits, poly.prepare_toeplitz_rhs(q, 3), 3)).astype(np.int64)
    err = np.abs((((got - want) + 2**31) % 2**32) - 2**31)
    assert err.max() <= G * N * 64 * 128  # worst-case dropped-limb accumulation


def test_toeplitz_asymmetric_plan():
    """Plan (4, 3): mask output bit-exact, body output = exact product of the
    byte-rounded body polynomial (the PEBA1_128_FAST configuration)."""
    rng = np.random.default_rng(11)
    B, G, O, N = 2, 4, 2, 128
    plan = (4, 3)
    digits = jnp.asarray(rng.integers(-128, 128, (B, G, N), dtype=np.int64).astype(np.int8))
    q = jnp.asarray(rng.integers(-(2**31), 2**31, (G, O, N), dtype=np.int64).astype(np.int32))
    got = np.asarray(poly.extprod_toeplitz_i8(digits, poly.prepare_toeplitz_rhs(q, plan), plan))
    # mask output (o=0) bit-exact vs the exact reference
    want = np.asarray(poly.negacyclic_extproduct_reference(digits, q))
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    # body output (o=1) = exact product of q rounded to its top 3 bytes
    # (mod-2^32 wrap semantics, matching poly.round_to_limbs)
    q_u = np.asarray(q).astype(np.uint32)
    q_body = ((q_u[:, 1] + 128) & np.uint32(0xFFFFFF00)).astype(np.int32)
    q2 = np.stack([np.asarray(q)[:, 0], q_body], axis=1)
    want_body = np.asarray(poly.negacyclic_extproduct_reference(digits, jnp.asarray(q2)))
    np.testing.assert_array_equal(got[:, 1], want_body[:, 1])
