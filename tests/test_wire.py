"""Wire codec tests: native C extension vs pure-python fallback equivalence."""

import jax
import numpy as np
import pytest

from peba1 import gates
from peba1.io import wire


def test_crc32c_vector():
    # RFC 3720 test vector
    assert wire.crc32c(b"123456789") == 0xE3069283


def test_frame_roundtrip():
    f = wire.frame_encode(2, b"payload bytes")
    kind, ver, payload = wire.frame_decode(f)
    assert (kind, ver, payload) == (2, 1, b"payload bytes")


def test_frame_corruption_detected():
    f = bytearray(wire.frame_encode(1, b"sensitive"))
    f[-3] ^= 0xFF
    with pytest.raises(ValueError):
        wire.frame_decode(bytes(f))


def test_bit_slice_roundtrip():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 2**24, (7, 5))
    bits = wire.bit_slice(v, 24)
    assert bits.shape == (7, 5, 24)
    np.testing.assert_array_equal(wire.bit_unslice(bits), v)


def test_native_matches_fallback():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 2**16, 64)
    fast = wire.bit_slice(v, 16)
    slow = ((np.asarray(v, np.int64)[..., None] >> np.arange(16)) & 1).astype(np.uint8)
    np.testing.assert_array_equal(fast, slow)
    data = rng.integers(0, 256, 999, dtype=np.uint8).tobytes()
    # python fallback crc must equal native crc
    crc_native = wire.crc32c(data)
    crc = ~0 & 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (0x82F63B78 ^ (crc >> 1)) if crc & 1 else crc >> 1
    assert (~crc & 0xFFFFFFFF) == crc_native


def test_ciphertext_wire_roundtrip(toy_keys):
    sk, _ = toy_keys
    bits = np.asarray([[1, 0, 1], [0, 1, 1]])
    ct = gates.encrypt_bits(jax.random.PRNGKey(0), sk, bits)
    blob = wire.encode_ciphertext(ct, meta={"kind": "bits"})
    ct2, meta = wire.decode_ciphertext(blob)
    assert meta["kind"] == "bits"
    np.testing.assert_array_equal(np.asarray(gates.decrypt_bits(ct2, sk)), bits)
