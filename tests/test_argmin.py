"""Encrypted tournament argmin (circuits.argmin_tree, Server.identify_argmin).

Clear-backend property tests pin the tournament semantics (min value,
lowest-index tie-breaking, odd sizes / byes); one toy-cipher end-to-end test
checks the full encrypted 1:N argmin identification against plaintext
distances.
"""

import jax
import numpy as np
import pytest

from peba1 import circuits as cc
from peba1.backends import ClearBackend
from peba1.params import ProtocolParams
from peba1.protocol import ClientDevice, Server
from peba1.utils.bits import bits_to_int

PROTO = ProtocolParams(nslots=2, bitsize=3, max_bitsize=9, mul_width=8, bound_match=4)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
def test_argmin_tree_clear_random(m):
    be = ClearBackend()
    rng = np.random.default_rng(m)
    w, ib = 6, 4
    vals = rng.integers(0, 1 << w, m)
    v_words = cc.const_word(be, vals, w, (m,))
    i_words = cc.const_word(be, np.arange(m), ib, (m,))
    mn, idx = cc.argmin_tree(be, v_words, i_words)
    assert int(bits_to_int(np.asarray(mn))) == int(vals.min())
    assert int(bits_to_int(np.asarray(idx))) == int(np.argmin(vals))


def test_argmin_tree_clear_ties_pick_lowest_index():
    be = ClearBackend()
    vals = np.asarray([9, 4, 4, 4, 11])
    v_words = cc.const_word(be, vals, 5, (5,))
    i_words = cc.const_word(be, np.arange(5), 3, (5,))
    _, idx = cc.argmin_tree(be, v_words, i_words)
    assert int(bits_to_int(np.asarray(idx))) == 1


def test_argmin_tree_clear_batched():
    be = ClearBackend()
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 64, (4, 3))  # tournament axis 0, batch axis 1
    v_words = cc.const_word(be, vals, 6, vals.shape)
    i_words = cc.const_word(
        be, np.broadcast_to(np.arange(4)[:, None], vals.shape), 2, vals.shape)
    mn, idx = cc.argmin_tree(be, v_words, i_words)
    np.testing.assert_array_equal(bits_to_int(np.asarray(mn)), vals.min(axis=0))
    np.testing.assert_array_equal(bits_to_int(np.asarray(idx)), np.argmin(vals, axis=0))


def test_identify_argmin_cipher_toy(toy_keys):
    sk, ck = toy_keys
    client = ClientDevice(7, sk, ck, PROTO)
    server = Server(ck, PROTO)
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    templates = np.asarray([[7, 7], [3, 5], [3, 4]])
    probe = np.asarray([3, 5])  # exact match with template 1
    templates_ct = client.encrypt_vector(k1, templates)
    probe_ct = client.encrypt_vector(k2, probe)
    enc_dist, enc_idx = server.identify_argmin(probe_ct, templates_ct)
    dist = int(client.decrypt_word(enc_dist))
    idx = int(client.decrypt_word(enc_idx))
    clear_d = ((templates - probe) ** 2).sum(axis=1)
    assert dist == int(clear_d.min()) == 0
    assert idx == int(np.argmin(clear_d)) == 1
