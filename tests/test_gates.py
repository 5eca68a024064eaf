"""Gate bootstrapping end-to-end: truth tables for every gate (SURVEY.md E5).

The reference validates its circuits by decrypt-and-compare against plaintext
(src/main.cpp:296-465); here we validate the gate layer itself first, over all
truth-table entries at once as one batch (the batching the reference lacks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from peba1 import gates, keys, lwe
from peba1.ops import bootstrap as bs
from peba1.params import TOY


@pytest.fixture(scope="module")
def ks(toy_keys):
    return toy_keys


def _enc(bits, sk, seed=0):
    return gates.encrypt_bits(jax.random.PRNGKey(seed), sk, jnp.asarray(bits))


def test_bootstrap_sign(ks):
    """bootstrap(+-1/8 input) returns phase ~ +-1/8 with small error."""
    sk, ck = ks
    bits = jnp.asarray([0, 1, 1, 0, 1, 0, 0, 1])
    ct = _enc(bits, sk)
    out = bs.bootstrap(ck, ct, gates.MU_1_8)
    ph = np.asarray(lwe.phase(out, sk.lwe_key)).astype(np.int64)
    want = np.where(np.asarray(bits) != 0, 2**29, -(2**29))
    # modswitch + decomposition truncation only (noiseless keys):
    # error well under 1/16 of the torus
    err = np.abs(ph - want)
    assert err.max() < 2**28, (ph, want)


TRUTH = {
    "AND": lambda a, b: a & b,
    "OR": lambda a, b: a | b,
    "NAND": lambda a, b: 1 - (a & b),
    "NOR": lambda a, b: 1 - (a | b),
    "XOR": lambda a, b: a ^ b,
    "XNOR": lambda a, b: 1 - (a ^ b),
    "ANDNY": lambda a, b: (1 - a) & b,
    "ANDYN": lambda a, b: a & (1 - b),
    "ORNY": lambda a, b: (1 - a) | b,
    "ORYN": lambda a, b: a | (1 - b),
}


def test_all_two_input_gates(ks):
    sk, ck = ks
    a_bits = jnp.asarray([0, 0, 1, 1])
    b_bits = jnp.asarray([0, 1, 0, 1])
    ca = _enc(a_bits, sk, seed=1)
    cb = _enc(b_bits, sk, seed=2)
    for name, fn in TRUTH.items():
        out = getattr(gates, name)(ck, ca, cb)
        got = np.asarray(gates.decrypt_bits(out, sk))
        want = fn(np.asarray(a_bits), np.asarray(b_bits))
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_free_gates(ks):
    sk, ck = ks
    bits = jnp.asarray([0, 1])
    ca = _enc(bits, sk, seed=3)
    np.testing.assert_array_equal(np.asarray(gates.decrypt_bits(gates.NOT(ck, ca), sk)), [1, 0])
    np.testing.assert_array_equal(np.asarray(gates.decrypt_bits(gates.COPY(ck, ca), sk)), [0, 1])
    c = gates.CONSTANT(ck, jnp.asarray([1, 0, 1]), shape=(3,))
    np.testing.assert_array_equal(np.asarray(gates.decrypt_bits(c, sk)), [1, 0, 1])


def test_mux_gate(ks):
    sk, ck = ks
    # all 8 combinations of (a, b, c)
    a = jnp.asarray([0, 0, 0, 0, 1, 1, 1, 1])
    b = jnp.asarray([0, 0, 1, 1, 0, 0, 1, 1])
    c = jnp.asarray([0, 1, 0, 1, 0, 1, 0, 1])
    out = gates.MUX(ck, _enc(a, sk, 4), _enc(b, sk, 5), _enc(c, sk, 6))
    got = np.asarray(gates.decrypt_bits(out, sk))
    want = np.where(np.asarray(a) != 0, np.asarray(b), np.asarray(c))
    np.testing.assert_array_equal(got, want)


def test_gate_composition_chain(ks):
    """Bootstrap outputs must be valid inputs to further gates (noise control)."""
    sk, ck = ks
    a = _enc(jnp.asarray([1, 0]), sk, 7)
    b = _enc(jnp.asarray([1, 1]), sk, 8)
    x = gates.AND(ck, a, b)          # [1, 0]
    y = gates.XOR(ck, x, b)          # [0, 1]
    z = gates.OR(ck, y, gates.NOT(ck, x))  # [0|0, 1|1] = [0, 1]
    np.testing.assert_array_equal(np.asarray(gates.decrypt_bits(z, sk)), [0, 1])


def test_batched_2d_shape(ks):
    """Gates broadcast over arbitrary leading dims (bit-sliced integers)."""
    sk, ck = ks
    bits = jnp.arange(12).reshape(3, 4) % 2
    ca = _enc(bits, sk, 9)
    cb = _enc(1 - bits, sk, 10)
    out = gates.XOR(ck, ca, cb)
    np.testing.assert_array_equal(np.asarray(gates.decrypt_bits(out, sk)), np.ones((3, 4)))
