"""Circuit-layer tests.

Strategy (SURVEY.md section 4): the levelized circuits run on the
ClearBackend (plaintext bits) and are checked against native arithmetic and
the uint64 mirror for many random inputs; a smaller set of cases then runs on
the CipherBackend with TOY keys to prove clear/cipher equivalence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from peba1 import circuits as cc
from peba1 import gates
from peba1.backends import CipherBackend, ClearBackend


def to_bits(v, nbits):
    v = np.asarray(v)
    return jnp.asarray(((v[..., None] >> np.arange(nbits)) & 1).astype(np.int32))


def from_bits(bits):
    bits = np.asarray(bits).astype(np.int64)
    return (bits << np.arange(bits.shape[-1])).sum(-1)


@pytest.fixture(scope="module")
def be():
    return ClearBackend()


def test_add_n(be):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, 64)
    b = rng.integers(0, 256, 64)
    s, carry = cc.add_n(be, to_bits(a, 8), to_bits(b, 8), 8)
    np.testing.assert_array_equal(from_bits(s), (a + b) % 256)
    np.testing.assert_array_equal(np.asarray(carry), (a + b) // 256)


def test_twos_complement(be):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, 64)
    out = cc.twos_complement(be, to_bits(a, 8), 8)
    np.testing.assert_array_equal(from_bits(out), (256 - a) % 256)


def test_abs_n(be):
    rng = np.random.default_rng(2)
    a = rng.integers(-128, 128, 64)
    out = cc.abs_n(be, to_bits(a % 256, 8), 8)
    np.testing.assert_array_equal(from_bits(out), np.abs(a))


def test_sub_abs(be):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, 64)
    b = rng.integers(1, 256, 64)  # b=0 triggers the faithful reference quirk
    out = cc.sub_abs(be, to_bits(a, 8), to_bits(b, 8), 8)
    assert out.shape[-1] == 9
    np.testing.assert_array_equal(from_bits(out), np.abs(a - b))


def test_shifts(be):
    a = np.asarray([0b10110101])
    l = cc.shift_left(be, to_bits(a, 8), 8, 2)
    r = cc.shift_right(be, to_bits(a, 8), 8, 2)
    np.testing.assert_array_equal(from_bits(l), (a << 2) % 256)
    np.testing.assert_array_equal(from_bits(r), a >> 2)


def test_multiply(be):
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, 32)
    b = rng.integers(0, 256, 32)
    out = cc.multiply(be, to_bits(a, 8), to_bits(b, 8), 8, length=23)
    assert out.shape[-1] == 23
    np.testing.assert_array_equal(from_bits(out), a * b)


def test_minimum(be):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**24, 64)
    b = rng.integers(0, 2**24, 64)
    mn, bit = cc.minimum(be, to_bits(a, 24), to_bits(b, 24), 24)
    np.testing.assert_array_equal(from_bits(mn), np.minimum(a, b))
    np.testing.assert_array_equal(from_bits(bit), (a > b).astype(np.int64))


def test_manhattan(be):
    rng = np.random.default_rng(6)
    a = rng.integers(1, 255, (5, 16))  # avoid 0: reference sub quirk (b=0)
    b = np.clip(a + rng.integers(-2, 3, a.shape), 1, 255)
    out = cc.manhattan(be, to_bits(a, 8), to_bits(b, 8), 8)
    assert out.shape[-1] == 9
    want = np.abs(b - a).sum(-1) % 256  # bitsize-wide accumulator overflow, faithfully
    np.testing.assert_array_equal(from_bits(out), want)


def test_euclidean(be):
    rng = np.random.default_rng(7)
    a = rng.integers(1, 255, (5, 16))  # avoid 0: reference sub quirk (b=0)
    b = np.clip(a + rng.integers(-3, 4, a.shape), 1, 255)
    out = cc.euclidean(be, to_bits(a, 8), to_bits(b, 8), 8, max_bitsize=24)
    assert out.shape[-1] == 24
    want = ((b - a) ** 2).sum(-1) % (1 << 23)
    np.testing.assert_array_equal(from_bits(out), want)


def test_function_f_polarity(be):
    """b = 1 iff ED > bound (the HE polarity -- inverted vs the clear mirror,
    SURVEY.md section 3.2)."""
    a = np.full((1, 128), 100)
    b_close = a + 1   # ED = 128
    b_far = a + 2     # ED = 512
    bound = cc.const_word(be, 256, 24, (1,))
    f_close = cc.function_f(be, to_bits(b_close, 8), to_bits(a, 8), bound, 8)
    f_far = cc.function_f(be, to_bits(b_far, 8), to_bits(a, 8), bound, 8)
    assert from_bits(f_close)[0] == 0  # 128 <= 256 -> no
    assert from_bits(f_far)[0] == 1    # 512 > 256 -> yes


def test_function_g(be):
    """Faithful semantics: b=1 -> y = r1; b=0 -> y = (-r0) mod 256.

    The b=0 case cascades the reference's sub_abs(.., 0) forced-sign-bit bug:
    (1 - 0) computes to 255, and 255*r0 mod 256 = -r0 (see sub_abs docstring;
    extends SURVEY.md section 3.2 discrepancy #3)."""
    r0 = np.asarray([17, 40])
    r1 = np.asarray([99, 200])
    for bval, want in ((0, (256 - r0) % 256), (1, r1)):
        b_word = cc.const_word(be, bval, 24, (2,))
        y = cc.function_g(be, b_word, to_bits(r0, 8), to_bits(r1, 8), 8)
        np.testing.assert_array_equal(from_bits(y), want)


# ---------------------------------------------------------------------------
# cipher/clear equivalence on TOY keys (smaller widths to keep CPU time sane)
# ---------------------------------------------------------------------------


def _enc_bits(bits, sk, seed):
    return gates.encrypt_bits(jax.random.PRNGKey(seed), sk, bits)


def test_cipher_add_matches_clear(toy_keys):
    sk, ck = toy_keys
    cbe, kbe = ClearBackend(), CipherBackend(ck)
    a, b = np.asarray([11, 250]), np.asarray([7, 9])
    ab, bb = to_bits(a, 8), to_bits(b, 8)
    s_clear, c_clear = cc.add_n(cbe, ab, bb, 8)
    s_ciph, c_ciph = cc.add_n(kbe, _enc_bits(ab, sk, 1), _enc_bits(bb, sk, 2), 8)
    np.testing.assert_array_equal(
        np.asarray(gates.decrypt_bits(s_ciph, sk)), np.asarray(s_clear))
    np.testing.assert_array_equal(
        np.asarray(gates.decrypt_bits(c_ciph, sk)), np.asarray(c_clear))


def test_cipher_sub_abs_matches_clear(toy_keys):
    sk, ck = toy_keys
    cbe, kbe = ClearBackend(), CipherBackend(ck)
    a, b = np.asarray([3, 12]), np.asarray([9, 5])
    ab, bb = to_bits(a, 4), to_bits(b, 4)
    want = cc.sub_abs(cbe, ab, bb, 4)
    got = cc.sub_abs(kbe, _enc_bits(ab, sk, 3), _enc_bits(bb, sk, 4), 4)
    np.testing.assert_array_equal(
        np.asarray(gates.decrypt_bits(got, sk)), np.asarray(want))
    np.testing.assert_array_equal(from_bits(want), np.abs(a - b))


def test_cipher_multiply_matches_clear(toy_keys):
    sk, ck = toy_keys
    cbe, kbe = ClearBackend(), CipherBackend(ck)
    a, b = np.asarray([5, 7]), np.asarray([6, 13])
    ab, bb = to_bits(a, 4), to_bits(b, 4)
    want = cc.multiply(cbe, ab, bb, 4, length=9)
    got = cc.multiply(kbe, _enc_bits(ab, sk, 5), _enc_bits(bb, sk, 6), 4, length=9)
    np.testing.assert_array_equal(
        np.asarray(gates.decrypt_bits(got, sk)), np.asarray(want))
    np.testing.assert_array_equal(from_bits(want), a * b)


def test_cipher_minimum_matches_clear(toy_keys):
    sk, ck = toy_keys
    cbe, kbe = ClearBackend(), CipherBackend(ck)
    a, b = np.asarray([12, 3]), np.asarray([5, 10])
    ab, bb = to_bits(a, 4), to_bits(b, 4)
    mn_c, bit_c = cc.minimum(cbe, ab, bb, 4)
    mn_k, bit_k = cc.minimum(kbe, _enc_bits(ab, sk, 7), _enc_bits(bb, sk, 8), 4)
    np.testing.assert_array_equal(np.asarray(gates.decrypt_bits(mn_k, sk)), np.asarray(mn_c))
    np.testing.assert_array_equal(np.asarray(gates.decrypt_bits(bit_k, sk)), np.asarray(bit_c))


def test_sub_abs_zero_quirk(be):
    """bootsSUBNbit(a, 0) == 2^n - a: the reference's forced-sign-bit bug,
    reproduced faithfully (src/Math.cpp:138)."""
    a = np.asarray([3, 100])
    out = cc.sub_abs(be, to_bits(a, 8), to_bits(np.zeros(2, int), 8), 8)
    np.testing.assert_array_equal(from_bits(out), 256 - a)


def test_shape_validation_real_errors():
    """SURVEY.md section 5 failure-detection row: the reference perror()s on
    size mismatches without aborting (src/Math.cpp:295-300,334-339); here
    they are real exceptions."""
    import pytest as _pytest

    from peba1 import circuits as _cc
    from peba1.backends import ClearBackend as _CB

    be = _CB()
    a = _cc.const_word(be, np.asarray([1, 2]), 3, (2,))      # 2 slots x 3 bits
    b3 = _cc.const_word(be, np.asarray([1, 2, 3]), 3, (3,))  # 3 slots
    with _pytest.raises(ValueError, match="slot-count mismatch"):
        _cc.manhattan(be, a, b3)
    b_w = _cc.const_word(be, np.asarray([1, 2]), 4, (2,))    # wrong width
    with _pytest.raises(ValueError, match="bit-width mismatch"):
        _cc.euclidean(be, a, b_w)
    bound = _cc.const_word(be, 4, 5)                          # must be 9 bits
    with _pytest.raises(ValueError, match="bound must be"):
        _cc.function_f(be, a, a, bound, 3)


def test_counting_backend_matches_cipher_execution(toy_keys):
    """CountingBackend's bootstrap count must equal what CipherBackend
    actually executes (counted at the gate/MUX/level call sites), and the
    toy-scale function_f count is pinned -- the protocol benchmarks derive
    effective-bootstraps/s from this counter, so it must not drift."""
    import jax
    import jax.numpy as jnp

    from peba1 import circuits as cc
    from peba1 import gates
    from peba1.backends import CipherBackend, CountingBackend
    from peba1.utils.bits import int_to_bits

    sk, ck = toy_keys
    nslots, bits = 4, 3
    t = np.array([[2, 3, 1, 2]])
    p = np.array([[1, 2, 1, 3]])
    tb, pb = int_to_bits(t, bits), int_to_bits(p, bits)
    bound = int_to_bits(np.array([8]), 3 * bits)

    executed = {"n": 0}

    class InstrumentedCipher(CipherBackend):
        def gate(self, name, a, b):
            executed["n"] += int(np.prod(
                jnp.broadcast_shapes(a.shape, b.shape), dtype=np.int64))
            return super().gate(name, a, b)

        def MUX(self, a, b, c):
            executed["n"] += 2 * int(np.prod(
                jnp.broadcast_shapes(a.shape, b.shape, c.shape),
                dtype=np.int64))
            return super().MUX(a, b, c)

        def level(self, ops):
            shape = jnp.broadcast_shapes(
                *[x.shape for _, a, b in ops for x in (a, b)])
            executed["n"] += len(ops) * int(np.prod(shape, dtype=np.int64))
            return super().level(ops)

    be = InstrumentedCipher(ck)
    t_ct = gates.encrypt_bits(jax.random.PRNGKey(1), sk, tb)
    p_ct = gates.encrypt_bits(jax.random.PRNGKey(2), sk, pb)
    b_ct = gates.encrypt_bits(jax.random.PRNGKey(3), sk, bound)
    out = cc.function_f(be, p_ct, t_ct, b_ct, bits)
    jax.block_until_ready(out.b)

    cb = CountingBackend()
    cc.function_f(cb, pb, tb, bound, bits)
    assert cb.bootstraps == executed["n"] == 1193
