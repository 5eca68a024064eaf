"""Checkpoint/resume 1:N sweep tests (sweep.py) + structured logging.

Invariants: (a) the chunked sweep's collected output equals one direct
`Server.identify` launch; (b) resume after an interruption recomputes only
the missing chunks; (c) a checkpoint dir is bound to one sweep (fingerprint
mismatch rejected).
"""

import json
import os

import jax
import numpy as np
import pytest

from peba1 import sweep as sweep_mod
from peba1.params import ProtocolParams
from peba1.protocol import ClientDevice, Server
from peba1.sweep import IdentifySweep
from peba1.utils.logging import EventLog

PROTO = ProtocolParams(nslots=2, bitsize=3, max_bitsize=9, mul_width=8, bound_match=4)
N_TEMPLATES = 5
CHUNK = 2


@pytest.fixture(scope="module")
def sweep_setup(toy_keys):
    sk, ck = toy_keys
    client = ClientDevice(7, sk, ck, PROTO)
    server = Server(ck, PROTO)
    k = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(k, 3)
    rng = np.random.default_rng(3)
    templates = rng.integers(0, 8, (N_TEMPLATES, PROTO.nslots))
    probe = np.asarray([3, 5])
    templates_ct = client.encrypt_vector(k1, templates)
    probe_ct = client.encrypt_vector(k2, probe)
    enc_bound = client.encrypt_word(k3, PROTO.bound_match, 3 * PROTO.bitsize)
    direct = jax.block_until_ready(
        server.identify(probe_ct, templates_ct, enc_bound))
    return client, server, probe_ct, templates_ct, enc_bound, direct


def test_sweep_matches_direct_identify(sweep_setup, tmp_path):
    client, server, probe_ct, templates_ct, enc_bound, direct = sweep_setup
    sw = IdentifySweep(server, str(tmp_path / "ckpt"), chunk=CHUNK)
    plan = sw.run(probe_ct, templates_ct, enc_bound)
    assert plan.n_chunks == -(-N_TEMPLATES // CHUNK)
    assert sw.completed_chunks() == list(range(plan.n_chunks))
    out = sw.collect()
    # Ciphertexts (not just decryptions) must agree: same batched circuit.
    np.testing.assert_array_equal(np.asarray(out.b), np.asarray(direct.b))
    np.testing.assert_array_equal(np.asarray(out.a), np.asarray(direct.a))
    # Decisions decrypt to the right non-match bits.
    got = client.decrypt_word(out)
    want = client.decrypt_word(direct)
    np.testing.assert_array_equal(got, want)


def test_sweep_resume_skips_done_chunks(sweep_setup, tmp_path):
    _, server, probe_ct, templates_ct, enc_bound, direct = sweep_setup
    d = str(tmp_path / "ckpt")
    events = []
    log = EventLog()
    log.log = lambda event, **f: events.append({"event": event, **f})
    sw = IdentifySweep(server, d, chunk=CHUNK, log=log)
    sw.run(probe_ct, templates_ct, enc_bound)
    done0 = [e for e in events if e["event"] == "sweep_done"][0]
    assert done0["computed"] == sw.completed_chunks().__len__()

    # Simulate a crash that lost the middle chunk.
    os.remove(os.path.join(d, "chunk_000001.npz"))
    events.clear()
    sw.run(probe_ct, templates_ct, enc_bound)
    done1 = [e for e in events if e["event"] == "sweep_done"][0]
    assert done1["computed"] == 1 and done1["resumed_from"] == done0["computed"] - 1
    out = sw.collect()
    np.testing.assert_array_equal(np.asarray(out.b), np.asarray(direct.b))


def test_sweep_rejects_foreign_checkpoint(sweep_setup, tmp_path):
    _, server, probe_ct, templates_ct, enc_bound, _ = sweep_setup
    d = str(tmp_path / "ckpt")
    sw = IdentifySweep(server, d, chunk=CHUNK)
    sw.run(probe_ct, templates_ct, enc_bound)
    # Different geometry => different fingerprint => refuse to resume.
    sw3 = IdentifySweep(server, d, chunk=3)
    with pytest.raises(ValueError, match="different sweep"):
        sw3.run(probe_ct, templates_ct, enc_bound)
    # resume=False wipes and reruns cleanly.
    plan = sw3.run(probe_ct, templates_ct, enc_bound, resume=False)
    assert sw3.completed_chunks() == list(range(plan.n_chunks))


def test_collect_flags_fingerprint_mismatch(sweep_setup, tmp_path):
    _, server, probe_ct, templates_ct, enc_bound, _ = sweep_setup
    d = str(tmp_path / "ckpt")
    sw = IdentifySweep(server, d, chunk=CHUNK)
    sw.run(probe_ct, templates_ct, enc_bound)
    # Corrupt the manifest fingerprint: collect must refuse.
    mpath = os.path.join(d, sweep_mod.MANIFEST)
    m = json.load(open(mpath))
    m["fingerprint"] = "0" * 16
    json.dump(m, open(mpath, "w"))
    with pytest.raises(ValueError, match="different sweep"):
        sw.collect()


def test_event_log_jsonl(tmp_path):
    p = str(tmp_path / "events.jsonl")
    log = EventLog(path=p, context={"run": "t"})
    log.log("hello", x=1)
    with log.timer("timed", tag="a") as extra:
        extra["items"] = 3
    log.count("gates", 5)
    log.count("gates", 2)
    log.close()
    lines = [json.loads(l) for l in open(p)]
    assert lines[0]["event"] == "hello" and lines[0]["x"] == 1 and lines[0]["run"] == "t"
    assert lines[1]["event"] == "timed" and lines[1]["seconds"] >= 0
    assert lines[1]["tag"] == "a" and lines[1]["items"] == 3
    assert log.counters["gates"] == 7
