"""N=2048 ring path (BASELINE.json config 4) exercised with a scaled-down n.

Full RING_2048 keygen/bootstrap is too heavy for CPU CI; a custom set with
N=2048, l=2, Bg=2^8 but small n covers the large-ring code paths (barrel
stages through s=2048, bgbit=8 digits at the int8 boundary, Toeplitz
assembly in 128-wide blocks with U=16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from peba1 import gates, keys, lwe
from peba1.ops import bootstrap as bs
from peba1.ops import poly
from peba1.params import RING_2048, TfheParams

SMALL_2048 = TfheParams(n=4, lwe_stdev=0.0, N=2048, k=1, tlwe_stdev=0.0,
                        l=2, bgbit=8, ks_t=8, ks_basebit=2)


def test_ring2048_extproduct_exact():
    rng = np.random.default_rng(0)
    p = SMALL_2048
    G, O, N, L = (p.k + 1) * p.l, p.k + 1, p.N, p.bk_limbs
    digits = jnp.asarray(
        rng.integers(-p.half_bg, p.half_bg, (2, G, N), dtype=np.int64).astype(np.int8))
    q = jnp.asarray(rng.integers(-(2**31), 2**31, (G, O, N), dtype=np.int64).astype(np.int32))
    want = np.asarray(poly.negacyclic_extproduct_reference(digits, q))
    got = np.asarray(poly.extprod_toeplitz_i8(digits, poly.prepare_toeplitz_rhs(q, L), L))
    np.testing.assert_array_equal(got, want)


def test_ring2048_gate_bootstrap(rng):
    """Both weight forms at N=2048: the production ring lattices build them
    in the graph (keys.precomputes_weights), this small-n one precomputes."""
    sk, ck = keys.keygen(rng, SMALL_2048)
    assert ck.bk_w is not None and not keys.precomputes_weights(RING_2048)
    bits = jnp.asarray([0, 1, 1, 0])
    ct = gates.encrypt_bits(jax.random.PRNGKey(1), sk, bits)
    out = bs.bootstrap(ck, ct, jnp.int32(gates.MU_1_8))
    np.testing.assert_array_equal(
        np.asarray(gates.decrypt_bits(out, sk)), np.asarray(bits))
    in_graph = bs.bootstrap(ck.replace(bk_w=None), ct, jnp.int32(gates.MU_1_8))
    np.testing.assert_array_equal(np.asarray(in_graph.a), np.asarray(out.a))
    np.testing.assert_array_equal(np.asarray(in_graph.b), np.asarray(out.b))


def test_ring2048_params_valid():
    # the production-size set passes the int8 exactness bound
    assert RING_2048.N == 2048 and RING_2048.bg == 256
