"""Noise-growth assertions (SURVEY.md section 7 step 3 test strategy).

With real (nonzero) noise parameters, phases must stay within budget through
encryption, bootstrap, and gate composition.  Statistical, fixed PRNG keys.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from peba1 import gates, keys, lwe
from peba1.ops import bootstrap as bs
from peba1.params import TOY_NOISY


@pytest.fixture(scope="module")
def noisy_keys(rng):
    return keys.keygen(rng, TOY_NOISY)


def _phase_err(ct, sk, bits):
    ph = np.asarray(lwe.phase(ct, sk.lwe_key)).astype(np.int64)
    want = np.where(np.asarray(bits) != 0, 2**29, -(2**29))
    d = (ph - want) % (1 << 32)
    return np.minimum(d, (1 << 32) - d)


def test_fresh_encryption_noise(noisy_keys):
    sk, _ = noisy_keys
    bits = jnp.arange(256) % 2
    ct = gates.encrypt_bits(jax.random.PRNGKey(1), sk, bits)
    err = _phase_err(ct, sk, bits)
    sigma = TOY_NOISY.lwe_stdev * 2**32
    assert err.max() < 6 * sigma
    assert err.std() > 0.3 * sigma  # actually noisy


def test_bootstrap_output_noise_within_budget(noisy_keys):
    sk, ck = noisy_keys
    bits = jnp.arange(128) % 2
    ct = gates.encrypt_bits(jax.random.PRNGKey(2), sk, bits)
    out = bs.bootstrap(ck, ct, jnp.int32(gates.MU_1_8))
    err = _phase_err(out, sk, bits)
    # decodable margin: well below 1/16 of the torus
    assert err.max() < 2**28
    np.testing.assert_array_equal(
        np.asarray(gates.decrypt_bits(out, sk)), np.asarray(bits))


def test_committed_noise_campaign_artifacts():
    """Pin the on-device chained-gate error campaigns (scripts/diag.py campaign).

    The throughput-tuned gadgets deviate from TFHE defaults (l=2/Bg=2^8,
    3-limb body, and the t2 set's N=512 modswitch); their viability for the
    ~2.2e5-gate protocol rests on the committed campaign artifacts: measured
    post-bootstrap phase sigma, the 1/16 decoding margin in sigma units, and
    zero observed errors over the full chained run.
    """
    import glob
    import json
    import math
    import os

    root = os.path.join(os.path.dirname(__file__), "..")
    paths = sorted(glob.glob(os.path.join(root, "NOISE_*.json")))
    # Hard requirement: the campaign evidence must exist -- a pin test that
    # skips when the record is missing pins nothing.
    assert paths, ("no committed NOISE_*.json campaign artifact; run "
                   "scripts/diag.py campaign --out NOISE_<params>.json")
    for path in paths:
        with open(path) as f:
            rec = json.load(f)
        assert rec["gates"] >= 10**6, path
        assert rec["chain_error_frac"] == 0.0, path
        assert rec["final_decode_errs"] == 0, path
        # Gaussian tail bound at the measured sigma: per-gate error must be
        # far below 1/2.2e5 (one 1:1 match) -- require < 1e-9/gate so even a
        # 10k-template 1:N sweep (~2.2e9 gates) stays at ~1% failure odds.
        sigma, margin = rec["phase_sigma"], rec["margin"]
        per_gate = math.erfc(margin / sigma / math.sqrt(2))
        assert per_gate < 1e-9, (path, per_gate)
        assert rec["margin_sigmas"] >= 6.0, path


def test_deep_gate_chain_stays_correct(noisy_keys):
    """Noise must not accumulate across bootstraps (each gate refreshes)."""
    sk, ck = noisy_keys
    bits = jnp.arange(32) % 2
    x = gates.encrypt_bits(jax.random.PRNGKey(3), sk, bits)
    y = gates.encrypt_bits(jax.random.PRNGKey(4), sk, 1 - bits)
    for i in range(6):
        x, y = gates.XOR(ck, x, y), gates.AND(ck, x, y)  # depth-6 chain
    got_x = np.asarray(gates.decrypt_bits(x, sk))
    # reference truth on plaintext bits
    bx, by = np.asarray(bits), 1 - np.asarray(bits)
    for i in range(6):
        bx, by = bx ^ by, bx & by
    np.testing.assert_array_equal(got_x, bx)
