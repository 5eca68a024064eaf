"""Serialization round-trips (SURVEY.md E9)."""

import jax
import numpy as np
import pytest

from peba1 import gates, lwe
from peba1.io import serial


def test_secret_key_roundtrip(tmp_path, toy_keys):
    sk, _ = toy_keys
    p = str(tmp_path / "sk.npz")
    serial.save_secret_key(p, sk)
    sk2 = serial.load_secret_key(p)
    np.testing.assert_array_equal(np.asarray(sk.lwe_key), np.asarray(sk2.lwe_key))
    np.testing.assert_array_equal(np.asarray(sk.tlwe_key), np.asarray(sk2.tlwe_key))
    assert sk.params == sk2.params


def test_cloud_key_roundtrip(tmp_path, toy_keys):
    _, ck = toy_keys
    p = str(tmp_path / "ck.npz")
    serial.save_cloud_key(p, ck)
    ck2 = serial.load_cloud_key(p)
    np.testing.assert_array_equal(np.asarray(ck.bk_tp), np.asarray(ck2.bk_tp))
    np.testing.assert_array_equal(np.asarray(ck.ks_table_limbs), np.asarray(ck2.ks_table_limbs))
    assert ck.params == ck2.params


@pytest.mark.parametrize("name", ["toy_t2", "toy_fast"])
def test_cloud_key_roundtrip_bootstraps_bit_equal(tmp_path, name):
    """A loaded cloud key holds exactly the stored key forms, and a bootstrap
    under it is bit-equal to one under the original (the t2 and 3-limb-body
    lattices, whose generator columns differ from TOY's)."""
    import jax.numpy as jnp

    from peba1 import keys
    from peba1.ops import bootstrap
    from peba1.params import PRESETS

    sk, ck = keys.keygen(jax.random.PRNGKey(3), PRESETS[name])
    path = str(tmp_path / f"ck_{name}.npz")
    serial.save_cloud_key(path, ck)
    ck2 = serial.load_cloud_key(path)
    assert ck2.params == ck.params
    assert jax.tree_util.tree_structure(ck2) == jax.tree_util.tree_structure(ck)

    bits = np.asarray([1, 0, 1, 1, 0])
    ct = gates.encrypt_bits(jax.random.PRNGKey(4), sk, bits)
    out1 = bootstrap.bootstrap(ck, ct, jnp.int32(gates.MU_1_8))
    out2 = bootstrap.bootstrap(ck2, ct, jnp.int32(gates.MU_1_8))
    np.testing.assert_array_equal(np.asarray(out1.a), np.asarray(out2.a))
    np.testing.assert_array_equal(np.asarray(out1.b), np.asarray(out2.b))
    np.testing.assert_array_equal(np.asarray(gates.decrypt_bits(out2, sk)), bits)


def test_ciphertext_roundtrip_decrypts(tmp_path, toy_keys):
    sk, ck = toy_keys
    bits = np.asarray([[1, 0], [0, 1], [1, 1]])
    ct = gates.encrypt_bits(jax.random.PRNGKey(0), sk, bits)
    p = str(tmp_path / "ct.npz")
    serial.save_ciphertext(p, ct, meta={"kind": "bits", "shape": list(bits.shape)})
    ct2, meta = serial.load_ciphertext(p)
    assert meta["kind"] == "bits"
    np.testing.assert_array_equal(np.asarray(gates.decrypt_bits(ct2, sk)), bits)
