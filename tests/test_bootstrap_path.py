"""The one bootstrap path (ops/bootstrap.blind_rotate) on every lattice shape.

Each CMUX step is rotate + decompose, an s8 x s8 -> s32 GEMM against the
step's Toeplitz weights (built in the graph from the generator key bk_tp),
then limb recombination.  These tests hold it to the exact int32 reference
(poly.negacyclic_extproduct_reference) against the TRGSW key itself, and to
bit-exact decoding of chained bootstraps.  N=256 cases exercise the
multi-block Toeplitz assembly (U = N/128 > 1).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from peba1 import gates, keys, tlwe
from peba1.ops import bootstrap as bs
from peba1.ops import decompose as dec
from peba1.ops import poly, rotate
from peba1.params import PRESETS, TOY, TOY_FAST, TOY_T2, TfheParams

LATTICES = [TOY, TOY_FAST, TOY_T2, dataclasses.replace(TOY, N=256),
            dataclasses.replace(TOY_T2, N=256)]
IDS = ["toy", "toy_fast", "toy_t2", "toy_n256", "toy_t2_n256"]


def _keys_and_trgsw(p):
    """keygen plus the TRGSW key it was built from (same PRNG split), with
    each output polynomial rounded to its limb plan: (n, G, O, N) int32."""
    key = jax.random.PRNGKey(0)
    sk, ck = keys.keygen(key, p)
    _, _, k_bk, _ = jax.random.split(key, 4)
    bk = tlwe.trgsw_encrypt(k_bk, sk.tlwe_key, sk.lwe_key, p)
    q = jnp.stack([poly.round_to_limbs(bk[:, :, o], nl)
                   for o, nl in enumerate(p.limb_plan)], axis=2)
    return sk, ck, q


@pytest.mark.parametrize("p", LATTICES, ids=IDS)
def test_step_extproduct_matches_reference(p):
    _, ck, q = _keys_and_trgsw(p)
    G = (p.k + 1) * p.l
    rng = np.random.default_rng(p.N + p.k)
    for s in (0, p.n // 2, p.n - 1):
        d = jnp.asarray(rng.integers(-p.half_bg, p.half_bg, (8, G, p.N)), jnp.int8)
        got = poly.extprod_w_i8(d.reshape(8, -1), poly.toeplitz_weights(ck.bk_tp[s]),
                                p.limb_plan, p.N)
        want = poly.negacyclic_extproduct_reference(d, q[s])
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("p", LATTICES, ids=IDS)
def test_cmux_step_matches_reference(p):
    """rotate + decompose + GEMM + recombine + accumulate, composed."""
    _, ck, q = _keys_and_trgsw(p)
    rng = np.random.default_rng(p.N)
    B, s = 6, p.n - 1
    acc = jnp.asarray(rng.integers(-2**31, 2**31, (B, p.k + 1, p.N)), jnp.int32)
    amt = jnp.asarray(rng.integers(0, 2 * p.N, B), jnp.int32)
    got = bs.cmux_step(p, acc, amt, poly.toeplitz_weights(ck.bk_tp[s]))
    d = dec.decompose(rotate.negacyclic_rotate(acc, amt[:, None]) - acc, p)
    d = jnp.moveaxis(d, -1, -2).reshape(B, (p.k + 1) * p.l, p.N)
    want = acc + poly.negacyclic_extproduct_reference(d, q[s])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("p", LATTICES, ids=IDS)
def test_chained_bootstraps_decode(p):
    sk, ck, _ = _keys_and_trgsw(p)
    bits = jnp.arange(32) % 2
    ct = gates.encrypt_bits(jax.random.PRNGKey(1), sk, bits)
    out = gates.and_chain(ck, ct, 2)
    np.testing.assert_array_equal(np.asarray(gates.decrypt_bits(out, sk)),
                                  np.asarray(bits))


@pytest.mark.parametrize("N", [16, 128, 256])
def test_toeplitz_weights_layout(N):
    """W^T[c*N + j, g*N + t] = vv[g, c, N - t + j]: column t is X^t times
    the polynomial whose doubled generator is vv."""
    G, C = 2, 3
    vv = np.random.default_rng(N).integers(-128, 128, (G, C, 2 * N)).astype(np.int8)
    wt = np.asarray(poly.toeplitz_weights(jnp.asarray(vv)))
    j = np.arange(N)[:, None]
    t = np.arange(N)[None, :]
    for g in range(G):
        for c in range(C):
            np.testing.assert_array_equal(
                wt[c * N:(c + 1) * N, g * N:(g + 1) * N], vv[g, c][N - t + j])


def test_params_hold_lattice_fields_only():
    assert {f.name for f in dataclasses.fields(TfheParams)} == {
        "n", "lwe_stdev", "N", "k", "tlwe_stdev", "l", "bgbit", "ks_t",
        "ks_basebit", "max_stdev", "bk_limbs", "bk_body_limbs"}


def test_presets_are_distinct_lattices():
    assert len(set(PRESETS.values())) == len(PRESETS)
    assert "peba1_128_t2" in PRESETS and "ring_2048_fast" in PRESETS


@pytest.mark.parametrize("p", LATTICES, ids=IDS)
def test_precomputed_weights_match_graph_form(p):
    """bk_w is exactly the per-step weights built from bk_tp, and a blind
    rotation reading it equals one that builds them in the graph."""
    _, ck, _ = _keys_and_trgsw(p)
    assert keys.precomputes_weights(p) and ck.bk_w is not None
    np.testing.assert_array_equal(
        np.asarray(ck.bk_w), np.asarray(jax.vmap(poly.toeplitz_weights)(ck.bk_tp)))
    rng = np.random.default_rng(5)
    bara = jnp.asarray(rng.integers(0, 2 * p.N, (16, p.n)), jnp.int32)
    barb = jnp.asarray(rng.integers(0, 2 * p.N, 16), jnp.int32)
    mu = jnp.int32(gates.MU_1_8)
    got = bs.blind_rotate(ck, bara, barb, mu)
    want = bs.blind_rotate(ck.replace(bk_w=None), bara, barb, mu)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_weight_form_per_lattice():
    """Precomputed weights where they fit the budget, else built in the graph."""
    form = {name: keys.precomputes_weights(p) for name, p in PRESETS.items()}
    assert form["peba1_128_t2"] and form["peba1_128_fast"]
    assert not (form["peba1_128"] or form["ring_2048"] or form["ring_2048_fast"])


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    from peba1.utils import cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_inside_checkout(monkeypatch):
    from peba1.utils import cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
