"""Plaintext-mirror tests: clear.py vs native arithmetic.

Mirrors the reference's plaintext test suite (src/main.cpp:107-290): validate
the bitwise algorithms against native ops over random inputs.
"""

import numpy as np

from peba1 import clear


def test_add_nbit_64():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**63, 128, dtype=np.uint64)
    b = rng.integers(0, 2**63, 128, dtype=np.uint64)
    np.testing.assert_array_equal(clear.add_nbit(a, b, 64), a + b)


def test_twos_complement_64():
    rng = np.random.default_rng(1)
    a = rng.integers(1, 2**63, 128, dtype=np.uint64)
    np.testing.assert_array_equal(clear.twos_complement(a, 64), -a)


def test_abs_64():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2**62, 128, dtype=np.uint64)
    np.testing.assert_array_equal(clear.abs_(a, 64), a)
    np.testing.assert_array_equal(clear.abs_(-a, 64), a)


def test_sub_nbit_64():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 255, 128, dtype=np.uint64)
    b = rng.integers(0, 255, 128, dtype=np.uint64)
    want = np.abs(a.astype(np.int64) - b.astype(np.int64)).astype(np.uint64)
    np.testing.assert_array_equal(clear.sub_nbit(a, b, 64), want)


def test_multiply_8bit():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, 128, dtype=np.uint64)
    b = rng.integers(0, 256, 128, dtype=np.uint64)
    np.testing.assert_array_equal(clear.multiply(a, b, 8), a * b)


def test_distances_vs_native():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 255, 128, dtype=np.uint64)
    b = np.minimum(a + 1, 255)
    # bitwise-on-64-bit variants match the native uint8 versions
    # (the reference's plaintext suite check, src/main.cpp:226-264)
    assert clear.manhattan_distance_bitwise(a, b, 64) == clear.manhattan_distance(a, b)
    assert clear.euclidean_distance_bitwise(a, b, 64) == clear.euclidean_distance(a, b)


def test_function_f_g_clear():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 255, 128, dtype=np.uint64)
    b = a + 1  # ED = 128
    assert clear.function_f_clear(a, b, 256, 64) == 1  # 128 <= 256
    assert clear.function_f_clear(a, a + 2, 256, 64) == 0  # 512 > 256
    assert clear.function_g_clear(0, 17, 99, 8) == 17
    assert clear.function_g_clear(1, 17, 99, 8) == 99


def test_approx_equals():
    assert clear.approx_equals(5, 9)
    assert not clear.approx_equals(5, 30)
