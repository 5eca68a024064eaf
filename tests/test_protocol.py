"""End-to-end PEBA1 protocol tests on toy crypto params.

The full encrypted flow of the reference driver (src/main.cpp:513-586):
enroll -> encrypt probe -> Function_f -> Function_g -> client decrypts y ->
verdicts.  Scaled-down protocol dims (nslots=2, bitsize=3) keep CPU time sane;
widths derive exactly like the reference's (max_bitsize = 3*bitsize,
multiplier accumulator 3*bitsize - 1).
"""

import jax
import numpy as np
import pytest

from peba1 import circuits as cc
from peba1 import gates
from peba1.backends import ClearBackend
from peba1.params import ProtocolParams
from peba1.protocol import ClientDevice, Server
from peba1.utils.bits import int_to_bits

PROTO = ProtocolParams(nslots=2, bitsize=3, max_bitsize=9, mul_width=8, bound_match=4)


@pytest.fixture(scope="module")
def system(toy_keys):
    sk, ck = toy_keys
    client = ClientDevice(7, sk, ck, PROTO)
    server = Server(ck, PROTO)
    return client, server


def _auth(client, server, template, probe, bound, seed=0):
    k = jax.random.PRNGKey(seed)
    k1, k2, k3, k4 = jax.random.split(k, 4)
    rec = client.enroll(k1, np.asarray(template))
    server.register(rec)
    probe_ct = client.encrypt_vector(k2, np.asarray(probe))
    enc_bound = client.encrypt_word(k3, bound, 3 * PROTO.bitsize)
    res = server.authenticate(k4, probe_ct, rec.template_ct, enc_bound)
    y = client.prove(res.enc_y)
    b = client.decrypt_word(res.enc_b)
    return b, y, res


def test_authenticate_match(system):
    client, server = system
    template, probe = [3, 5], [4, 6]  # ED = 2 <= bound 4
    b, y, res = _auth(client, server, template, probe, PROTO.bound_match)
    assert b == 0  # faithful polarity: 0 = match
    assert int(y) == (8 - int(res.r0)) % 8  # y = -r0 mod 2^bitsize
    v = server.verify_proof(res, y)
    assert bool(v["is_match"]) or int(y) == int(res.r1)  # r collision tolerated


def test_authenticate_nonmatch(system):
    client, server = system
    template, probe = [3, 5], [6, 1]  # ED = 9 + 16 = 25 > 4
    b, y, res = _auth(client, server, template, probe, PROTO.bound_match, seed=1)
    assert b == 1
    assert int(y) == int(res.r1)
    v = server.verify_proof(res, y)
    assert bool(v["reference_verdict"])


def test_cipher_function_f_matches_clear(system):
    client, server = system
    cbe = ClearBackend()
    template, probe = np.asarray([2, 7]), np.asarray([3, 4])
    tb = int_to_bits(template, PROTO.bitsize)
    pb = int_to_bits(probe, PROTO.bitsize)
    bound_bits = cc.const_word(cbe, PROTO.bound_match, 3 * PROTO.bitsize, ())
    want = np.asarray(cc.function_f(cbe, pb, tb, bound_bits, PROTO.bitsize))

    k = jax.random.PRNGKey(5)
    k1, k2, k3 = jax.random.split(k, 3)
    t_ct = client.encrypt_vector(k1, template)
    p_ct = client.encrypt_vector(k2, probe)
    b_ct = client.encrypt_word(k3, PROTO.bound_match, 3 * PROTO.bitsize)
    got_ct = server.function_f(p_ct, t_ct, b_ct)
    got = np.asarray(gates.decrypt_bits(got_ct, client.sk))
    np.testing.assert_array_equal(got, want)


def test_identify_batch(system):
    client, server = system
    k = jax.random.PRNGKey(9)
    k1, k2, k3 = jax.random.split(k, 3)
    templates = np.asarray([[3, 5], [6, 1], [4, 6]])
    probe = np.asarray([4, 6])
    t_ct = client.encrypt_vector(k1, templates)       # (3, nslots, bitsize)
    p_ct = client.encrypt_vector(k2, probe)           # (nslots, bitsize)
    enc_bound = client.encrypt_word(k3, PROTO.bound_match, 3 * PROTO.bitsize)
    out = server.identify(p_ct, t_ct, enc_bound)      # (3, 9) bit words
    got = client.decrypt_word(out)
    # ED(probe, t): [2, 29, 0] vs bound 4 -> non-match bits [0, 1, 0]
    np.testing.assert_array_equal(got, [0, 1, 0])
