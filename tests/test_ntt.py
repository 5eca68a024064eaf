"""Exact-integer negacyclic NTT prototype vs the naive oracle (SURVEY E8)."""

import numpy as np
import pytest

from peba1.ops import ntt, poly


@pytest.mark.parametrize("N", [128, 512, 2048])
def test_ntt_roundtrip(N):
    rng = np.random.default_rng(N)
    x = rng.integers(-(1 << 20), 1 << 20, (3, N)).astype(np.int32)
    X = ntt.ntt_negacyclic(x)
    back = np.asarray(ntt.intt_negacyclic(X))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("N", [128, 512, 2048])
def test_ntt_negacyclic_mul_matches_naive(N):
    """Digit x key-limb shaped inputs (the external-product path): the NTT
    product must equal ops/poly.negacyclic_mul_naive bit-for-bit (both are
    exact integers; the naive path wraps mod 2^32 but values stay < 2^25
    here, so representations agree)."""
    rng = np.random.default_rng(N + 1)
    a = rng.integers(-128, 128, (2, N)).astype(np.int32)   # gadget digits
    b = rng.integers(-128, 128, (2, N)).astype(np.int32)   # int8 key limbs
    got = np.asarray(ntt.negacyclic_mul_exact(a, b))
    want = np.asarray(poly.negacyclic_mul_naive(a, b))
    np.testing.assert_array_equal(got, want)


def test_ntt_mul_linearity_vs_toeplitz_column():
    """Cross-check a second oracle: one column slice of the Toeplitz form."""
    N = 256
    rng = np.random.default_rng(9)
    a = rng.integers(-128, 128, (1, N)).astype(np.int32)
    b = rng.integers(-128, 128, (1, N)).astype(np.int32)
    got = np.asarray(ntt.negacyclic_mul_exact(a, b))[0]
    # naive direct O(N^2) in numpy int64 (no wrap): c_j = sum_t a_t*b_{j-t}
    # with negacyclic sign on wrapped indices.
    c = np.zeros(N, np.int64)
    for t in range(N):
        for j in range(N):
            jj = (t + j) % N
            s = -1 if t + j >= N else 1
            c[jj] += s * int(a[0, t]) * int(b[0, j])
    np.testing.assert_array_equal(got, c.astype(np.int32))
