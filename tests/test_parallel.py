"""Sharded-vs-single-device equality on the 8-device virtual CPU mesh
(SURVEY.md section 4's multi-host-without-a-pod strategy)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from peba1 import gates, lwe
from peba1.ops import bootstrap as bs
from peba1.parallel import mesh as pmesh
from peba1.parallel import shard as pshard


def test_sharded_bootstrap_equals_single(toy_keys):
    sk, ck = toy_keys
    assert len(jax.devices()) == 8
    m = pmesh.make_mesh(n_dp=4, n_tp=2)
    B = 16
    bits = jnp.arange(B) % 2
    ct = gates.encrypt_bits(jax.random.PRNGKey(3), sk, bits)
    pre = lwe.Lwe(ct.a * 1, ct.b * 1)  # treat as bootstrap input directly

    want = bs.bootstrap(ck, pre, jnp.int32(gates.MU_1_8))
    got = pshard.sharded_bootstrap(m, ck, pre, jnp.int32(gates.MU_1_8))
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(want.b))


def test_sharded_bootstrap_dp_only(toy_keys):
    sk, ck = toy_keys
    m = pmesh.make_mesh(n_dp=8, n_tp=1)
    B = 8
    bits = jnp.ones(B, jnp.int32)
    ct = gates.encrypt_bits(jax.random.PRNGKey(4), sk, bits)
    want = bs.bootstrap(ck, ct, jnp.int32(gates.MU_1_8))
    got = pshard.sharded_bootstrap(m, ck, ct, jnp.int32(gates.MU_1_8))
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(want.b))


def test_toeplitz_cols_matches_full():
    """Unit: the traced-start column slice == columns of the full Toeplitz."""
    from peba1.ops import poly

    rng = np.random.default_rng(3)
    N = 128
    q = jnp.asarray(rng.integers(-(2**31), 2**31, (2, 3, N), dtype=np.int64)
                    .astype(np.int32))
    vv = poly.prepare_toeplitz_rhs(q, 4)          # (G, C, 2N) int8
    C = vv.shape[1]
    full = np.asarray(poly.toeplitz_weights(vv)).reshape(C, N, -1)
    for nj in (32, 128):
        for j0 in sorted({0, min(32, N - nj), N - nj}):
            cols = poly.toeplitz_weights(vv, jnp.int32(j0), nj)
            np.testing.assert_array_equal(
                np.asarray(cols).reshape(C, nj, -1), full[:, j0:j0 + nj])


def test_extprod_cols_matches_full():
    from peba1.ops import poly
    from peba1.params import TOY

    p = TOY
    sk, ck = None, None  # keys not needed: random generator directly
    rng = np.random.default_rng(4)
    G = (p.k + 1) * p.l
    q = jnp.asarray(rng.integers(-(2**31), 2**31, (G, p.k + 1, p.N),
                                 dtype=np.int64).astype(np.int32))
    vv = poly.prepare_toeplitz_rhs(q, p.limb_plan)
    d = jnp.asarray(rng.integers(-p.half_bg, p.half_bg, (8, G, p.N)), jnp.int8)
    want = poly.extprod_toeplitz_i8(d, vv, p.limb_plan)
    nj = p.N // 4
    parts = [poly.extprod_toeplitz_cols_i8(d, vv, p.limb_plan,
                                           jnp.int32(r * nj), nj)
             for r in range(4)]
    got = jnp.concatenate(parts, axis=-1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_ringtp_bootstrap_equals_single(toy_keys):
    """Ring-dimension TP (per-step W columns sharded over tp, delta
    all_gathered) == single-device bootstrap, bit-exact."""
    import dataclasses

    sk, ck = toy_keys
    # Force the plain toeplitz path on the single-device side (same math).
    m = pmesh.make_mesh(n_dp=2, n_tp=4)
    B = 8
    bits = jnp.arange(B) % 2
    ct = gates.encrypt_bits(jax.random.PRNGKey(6), sk, bits)
    want = bs.bootstrap(ck, ct, jnp.int32(gates.MU_1_8))
    got = pshard.sharded_bootstrap_ringtp(m, ck, ct, jnp.int32(gates.MU_1_8))
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(
        np.asarray(gates.decrypt_bits(got, sk)), np.asarray(bits))


def test_ringtp_overlap_blocks_equals_single(toy_keys):
    """Chunked-column-gather ring-TP (overlap_blocks=2: per-step delta
    gathered in two blocks so the collective can hide behind the next
    block's GEMM) == single-device bootstrap, bit-exact -- the reassembly
    is pure column reordering."""
    sk, ck = toy_keys
    m = pmesh.make_mesh(n_dp=2, n_tp=4)
    B = 8
    bits = (jnp.arange(B) + 1) % 2
    ct = gates.encrypt_bits(jax.random.PRNGKey(7), sk, bits)
    want = bs.bootstrap(ck, ct, jnp.int32(gates.MU_1_8))
    got = pshard.sharded_bootstrap_ringtp(m, ck, ct, jnp.int32(gates.MU_1_8),
                                          overlap_blocks=2)
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(
        np.asarray(gates.decrypt_bits(got, sk)), np.asarray(bits))


def test_sharded_tree_sum_equals_single(toy_keys):
    """Slot-sum reduction over the mesh (local bootstrapped adder trees +
    gathered finish) == single-device circuits.tree_sum, bit-exact -- the
    mechanism behind sharded_euclidean (compare the sharded-argmin pattern:
    the full distance pipeline in one shard_map program is minutes of XLA
    CPU compile on the virtual mesh, the mechanism is seconds)."""
    from peba1 import circuits as cc
    from peba1.backends import CipherBackend
    from peba1.utils.bits import bits_to_int, int_to_bits

    sk, ck = toy_keys
    nslots, W = 8, 4
    rng = np.random.default_rng(12)
    vals = rng.integers(0, 1 << (W - 1), (2, nslots))
    words = gates.encrypt_bits(jax.random.PRNGKey(8), sk, int_to_bits(vals, W))

    be = CipherBackend(ck)
    want = cc.tree_sum(be, words, width=W)

    m = pmesh.make_mesh(n_dp=2, n_tp=4)
    got = pshard.sharded_tree_sum(m, ck, words, width=W)
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(want.b))
    d = bits_to_int(np.asarray(gates.decrypt_bits(got, sk)))
    np.testing.assert_array_equal(d, vals.sum(1) % (1 << W))


def _enc_protocol_inputs(sk, n_templates=8, nslots=2, bitsize=3, seed=7):
    """Tiny encrypted 1:N instance: (probe, templates, bound, plain values)."""
    from peba1 import circuits as cc
    from peba1.utils.bits import int_to_bits

    rng = np.random.default_rng(seed)
    tmpl = rng.integers(0, 1 << bitsize, (n_templates, nslots))
    probe = tmpl[n_templates // 2] ^ 1  # close to one template
    k = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(k)
    probe_ct = gates.encrypt_bits(k1, sk, int_to_bits(probe, bitsize))
    tmpl_ct = gates.encrypt_bits(k2, sk, int_to_bits(tmpl, bitsize))
    return probe_ct, tmpl_ct, tmpl, probe


def test_sharded_argmin_equals_single(toy_keys):
    """The cross-shard tournament mechanism (local argmin + finalist
    all_gather + replicated finish) == single-device argmin_tree, including
    the encrypted index words and tie-breaks (power-of-two shards give the
    identical compare tree)."""
    from peba1 import circuits as cc
    from peba1.backends import CipherBackend
    from peba1.utils.bits import bits_to_int, int_to_bits

    sk, ck = toy_keys
    M, W = 8, 4
    rng = np.random.default_rng(11)
    vals = rng.integers(0, 1 << W, M)
    vals[3] = vals[6] = vals.min()  # force a tie: lowest index must win
    vals_ct = gates.encrypt_bits(jax.random.PRNGKey(5), sk, int_to_bits(vals, W))
    be = CipherBackend(ck)
    idx_ct = cc.const_word(be, np.arange(M), 3, (M,))

    want_v, want_i = cc.argmin_tree(be, vals_ct, idx_ct)
    m = pmesh.make_mesh(n_dp=4, n_tp=2)
    got_v, got_i = pshard.sharded_argmin(m, ck, vals_ct, idx_ct)
    np.testing.assert_array_equal(np.asarray(got_v.a), np.asarray(want_v.a))
    np.testing.assert_array_equal(np.asarray(got_v.b), np.asarray(want_v.b))
    np.testing.assert_array_equal(np.asarray(got_i.a), np.asarray(want_i.a))
    np.testing.assert_array_equal(np.asarray(got_i.b), np.asarray(want_i.b))
    idx = bits_to_int(np.asarray(gates.decrypt_bits(got_i, sk)))
    assert idx == int(np.argmin(vals))


def test_gspmd_identify_and_argmin(toy_keys):
    """Full 1:N pipeline on the mesh via GSPMD sharding annotations: the
    template DB is placed dp-sharded and the per-level circuit partitions
    over the 8 virtual devices (per-level compiles are seconds, vs minutes
    for the one-program shard_map form below).  Decisions and the tournament
    argmin index/distance are asserted against plaintext, and bit-equality
    with the unsharded run is asserted directly (same per-level programs,
    different layout)."""
    from peba1 import circuits as cc
    from peba1 import protocol
    from peba1.backends import CipherBackend
    from peba1.protocol import ProtocolParams
    from peba1.utils.bits import bits_to_int

    sk, ck = toy_keys
    nslots, bitsize = 1, 2
    # Explicit NONZERO slot values: probe slot 0 would trigger the faithful
    # sub_abs forced-sign quirk (|t - 0| -> 2^bits - t, src/Math.cpp:138) and
    # the naive plaintext expectation below would be wrong (the golden
    # corpus avoids zero slots for the same reason).  Values force both
    # verdict classes AND an argmin tie (indices 1 and 5; lowest must win).
    from peba1.utils.bits import int_to_bits
    tmpl = np.array([[1], [2], [3], [1], [3], [2], [1], [3]])
    probe = np.array([2])
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    probe_ct = gates.encrypt_bits(k1, sk, int_to_bits(probe, bitsize))
    tmpl_ct = gates.encrypt_bits(k2, sk, int_to_bits(tmpl, bitsize))
    be = CipherBackend(ck)
    bound = 0
    enc_bound = cc.const_word(be, bound, 3 * bitsize)
    proto = ProtocolParams(nslots=nslots, bitsize=bitsize,
                           max_bitsize=3 * bitsize, mul_width=3 * bitsize - 1,
                           bound_match=bound)
    server = protocol.Server(ck, proto)
    m = pmesh.make_mesh(n_dp=4, n_tp=2)

    want = server.identify(probe_ct, tmpl_ct, enc_bound)
    got = pshard.gspmd_identify(m, server, probe_ct, tmpl_ct, enc_bound)
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(want.b))
    d = ((tmpl - probe) ** 2).sum(1)
    got_b = bits_to_int(np.asarray(gates.decrypt_bits(got, sk)))
    np.testing.assert_array_equal(got_b, (d > bound).astype(int))

    want_v, want_i = server.identify_argmin(probe_ct, tmpl_ct)
    got_v, got_i = pshard.gspmd_identify_argmin(m, server, probe_ct, tmpl_ct)
    np.testing.assert_array_equal(np.asarray(got_v.b), np.asarray(want_v.b))
    np.testing.assert_array_equal(np.asarray(got_i.b), np.asarray(want_i.b))
    assert int(bits_to_int(np.asarray(gates.decrypt_bits(got_i, sk)))) == \
        int(np.argmin(d))


HEAVY = pytest.mark.skipif(
    not os.environ.get("PEBA1_HEAVY_TESTS"),
    reason="the ONE-PROGRAM shard_map of the full identify circuit costs "
           "~12 min for the pair even at nslots=1/bitsize=2 (measured "
           "2026-08-21: both PASS, 11m52s cold / 10m13s with a warm "
           "compile cache -- the cost is tracing, not XLA compile, so "
           "the persistent cache cannot amortize it); its mechanisms "
           "(sharded_argmin, sharded_tree_sum, ringtp) and the full "
           "pipeline (GSPMD form above) are covered un-gated")


@HEAVY
def test_sharded_identify_equals_single(toy_keys):
    """Template-DB-over-dp Function_f sweep == single-device identify
    (one-program shard_map form)."""
    from peba1 import protocol
    from peba1 import circuits as cc
    from peba1.backends import CipherBackend
    from peba1.protocol import ProtocolParams

    sk, ck = toy_keys
    nslots, bitsize = 1, 2
    probe_ct, tmpl_ct, _, _ = _enc_protocol_inputs(sk, 8, nslots, bitsize)
    be = CipherBackend(ck)
    enc_bound = cc.const_word(be, 3, 3 * bitsize)

    proto = ProtocolParams(nslots=nslots, bitsize=bitsize,
                           max_bitsize=3 * bitsize, bound_match=3)
    server = protocol.Server(ck, proto)
    want = server.identify(probe_ct, tmpl_ct, enc_bound)

    m = pmesh.make_mesh(n_dp=4, n_tp=2)
    got = pshard.sharded_identify(m, ck, probe_ct, tmpl_ct, enc_bound, bitsize)
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(want.b))


@HEAVY
def test_sharded_identify_argmin_equals_single(toy_keys):
    """dp-sharded tournament argmin == single-device argmin_tree, incl. the
    encrypted index words (power-of-two shards => identical compare tree).
    One-program shard_map form (see HEAVY note)."""
    from peba1 import circuits as cc
    from peba1 import protocol
    from peba1.protocol import ProtocolParams

    sk, ck = toy_keys
    nslots, bitsize = 1, 2
    probe_ct, tmpl_ct, tmpl, probe = _enc_protocol_inputs(sk, 8, nslots, bitsize)
    proto = ProtocolParams(nslots=nslots, bitsize=bitsize,
                           max_bitsize=3 * bitsize)
    server = protocol.Server(ck, proto)
    want_v, want_i = server.identify_argmin(probe_ct, tmpl_ct)

    m = pmesh.make_mesh(n_dp=4, n_tp=2)
    got_v, got_i = pshard.sharded_identify_argmin(
        m, ck, probe_ct, tmpl_ct, bitsize, proto.max_bitsize)
    np.testing.assert_array_equal(np.asarray(got_v.a), np.asarray(want_v.a))
    np.testing.assert_array_equal(np.asarray(got_v.b), np.asarray(want_v.b))
    np.testing.assert_array_equal(np.asarray(got_i.a), np.asarray(want_i.a))
    np.testing.assert_array_equal(np.asarray(got_i.b), np.asarray(want_i.b))

    # And the decrypted verdict is the true plaintext argmin.
    from peba1.utils.bits import bits_to_int
    idx = bits_to_int(np.asarray(gates.decrypt_bits(got_i, sk)))
    d = ((tmpl - probe) ** 2).sum(axis=1)
    assert idx == int(np.argmin(d))
