#!/usr/bin/env python3
"""Smoke test of the PEBA1 stack on one NVIDIA GPU, at full width.

    python chip_smoke.py               # phases 1-4, one card
    python chip_smoke.py --four-cards  # phase 5 only, four cards of one host

Phases (each prints its seconds; any failure exits non-zero before the
result line):
  1. device: a GPU is required -- there is no CPU fallback;
  2. the step external product (in-graph Toeplitz weights + s8 GEMM + limb
     recombination) against poly.negacyclic_extproduct_reference on sampled
     bootstrapping-key steps, exact, at the t2 and N=2048 widths;
  3. chained AND(x, x) bootstraps at B=8192 on every lattice, 100% decode;
  4. the protocol at 128 slots x 8 bits on peba1_128_t2: keygen, enroll,
     authenticate + prove + verify_proof, identify over 4 templates, every
     decision against the plaintext mirror;
  5. (--four-cards) 1:N identification dp-sharded over 4 cards and the
     N=2048 ring-dimension tensor-parallel bootstrap (tp=4), each bit-equal
     to the one-card result and to the plaintext mirror.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

B_CHAIN = 8192
CHAIN_LATTICES = ("peba1_128", "peba1_128_fast", "peba1_128_t2",
                  "ring_2048", "ring_2048_fast")


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu() -> list:
    """The devices, if JAX's first one is a GPU; otherwise exit non-zero."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found "
                         f"{devices[0].platform} ({devices[0].device_kind})")
    return devices


def card_name_and_power_limit() -> str:
    """nvidia-smi's name and power limit, read by a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def keygen(name: str, seed: int = 0):
    from peba1 import keys
    from peba1.params import PRESETS
    kg = jax.jit(keys.keygen, static_argnames=("params",))
    sk, ck = kg(jax.random.PRNGKey(seed), params=PRESETS[name])
    return jax.block_until_ready((sk, ck))


def peak_bytes(device) -> int:
    return int((device.memory_stats() or {}).get("peak_bytes_in_use", -1))


# ------------------------------------------------------------------ phase 2
def check_step_extproduct(name: str, rows: int = 64, batch: int = B_CHAIN) -> None:
    """Step external product vs the exact int32 reference on sampled steps,
    with the weights the bootstrap reads for this lattice: precomputed
    (bk_w) or built in the graph from bk_tp."""
    from peba1.ops import bootstrap as bs
    from peba1.ops import poly
    sk, ck = keygen(name)
    p = ck.params
    G, N, plan = (p.k + 1) * p.l, p.N, p.limb_plan
    form = "precomputed" if ck.bk_w is not None else "built in the graph"
    ext = jax.jit(lambda d, w: poly.extprod_w_i8(
        d.reshape(d.shape[0], -1), w, plan, N))
    weights = jax.jit(poly.toeplitz_weights)
    # The generator's positive half holds the limbs of each key polynomial.
    ref = jax.jit(lambda d, vv: poly.negacyclic_extproduct_reference(
        d, poly.recombine_plan_i32(vv[..., N:].astype(jnp.int32), plan)))
    rng = np.random.default_rng(7)
    for s in (0, p.n // 2, p.n - 1):
        d = jnp.asarray(rng.integers(-p.half_bg, p.half_bg, (rows, G, N)),
                        jnp.int8)
        w = ck.bk_w[s] if ck.bk_w is not None else weights(ck.bk_tp[s])
        got, want = np.asarray(ext(d, w)), np.asarray(ref(d, ck.bk_tp[s]))
        if not np.array_equal(got, want):
            raise SystemExit(f"{name}: step {s} external product differs from "
                             f"the reference in {(got != want).sum()} entries")
    log(f"[kernels] {name}: G*N={G * N} C*N={sum(plan) * N}, weights {form}: "
        f"step external product == reference at steps 0, {p.n // 2}, "
        f"{p.n - 1} ({rows} rows)")
    acc = jax.ShapeDtypeStruct((batch, p.k + 1, N), jnp.int32)
    amt = jax.ShapeDtypeStruct((batch,), jnp.int32)
    w = jax.ShapeDtypeStruct((sum(plan) * N, G * N), jnp.int8)
    step = jax.jit(lambda a, t, v: bs.cmux_step(p, a, t, v)).lower(acc, amt, w)
    log(f"[kernels] {name}: cmux_step at B={batch} memory_analysis: "
        f"{step.compile().memory_analysis()}")


# ------------------------------------------------------------------ phase 3
def check_chain(name: str, batch: int = B_CHAIN, steps: int = 2) -> float:
    """Chained AND(x, x) bootstraps; returns gate bootstraps/s (warm)."""
    from peba1 import gates
    sk, ck = keygen(name)
    bits = jnp.asarray(np.random.default_rng(1).integers(0, 2, batch))
    ct = gates.encrypt_bits(jax.random.PRNGKey(2), sk, bits)
    t0 = time.perf_counter()
    jax.block_until_ready(gates.and_chain(ck, ct, steps))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(gates.and_chain(ck, ct, steps))
    warm = time.perf_counter() - t0
    ok = float((np.asarray(gates.decrypt_bits(out, sk)) == np.asarray(bits)).mean())
    rate = batch * steps / warm
    log(f"[engine] {name}: B={batch} chain={steps}: decode {ok * 100:.2f}%, "
        f"{rate:.1f} gate bootstraps/s warm ({warm:.3f}s; first call "
        f"{cold:.1f}s incl. compile)")
    if ok != 1.0:
        raise SystemExit(f"{name}: chained bootstraps decoded {ok:.6f}, not 1.0")
    return rate


# ------------------------------------------------------------------ phase 4
def mirror_decision(template, probe, bound: int) -> int:
    """Function_f's bit from the plaintext mirror: 1 iff ED > bound
    (function_f_clear has the inverted polarity, clear.py)."""
    from peba1 import clear
    return 1 - int(clear.function_f_clear(template, probe, bound, 64))


def protocol_vectors(rng, n_templates: int, nslots: int, bitsize: int):
    """A probe and templates: the first half genuine (ED = nslots, each slot
    one away), the rest impostors.  Values stay in [1, 2^bitsize - 1]: a zero
    slot hits the reference's forced-sign sub_abs quirk."""
    hi = (1 << bitsize) - 1
    probe = rng.integers(2, hi, nslots)
    genuine = n_templates // 2
    templates = np.stack(
        [probe - 1] * genuine
        + [rng.integers(1, hi + 1, nslots) for _ in range(n_templates - genuine)])
    return probe, templates


def check_protocol(name: str = "peba1_128_t2", proto=None, seed: int = 11) -> None:
    from peba1 import circuits as cc
    from peba1.backends import CountingBackend
    from peba1.params import PEBA1_PROTOCOL
    from peba1.protocol import ClientDevice, Server
    from peba1.utils.bits import int_to_bits

    proto = proto or PEBA1_PROTOCOL
    dev = jax.devices()[0]
    t0 = time.perf_counter()
    sk, ck = keygen(name, seed)
    log(f"[protocol] {name} keygen {time.perf_counter() - t0:.1f}s")
    client, server = ClientDevice(7, sk, ck, proto), Server(ck, proto)
    rng = np.random.default_rng(seed)
    probe, templates = protocol_vectors(rng, 4, proto.nslots, proto.bitsize)
    bound = proto.bound_match
    keys = jax.random.split(jax.random.PRNGKey(seed), 5)
    rec = client.enroll(keys[0], templates[0])
    server.register(rec)
    probe_ct = client.encrypt_vector(keys[1], probe)
    enc_bound = client.encrypt_word(keys[2], bound, proto.max_bitsize)

    counter = CountingBackend()
    cc.function_f(counter, int_to_bits(probe, proto.bitsize),
                  int_to_bits(templates[0], proto.bitsize),
                  cc.const_word(counter, bound, proto.max_bitsize),
                  proto.bitsize)
    gates_f = counter.bootstraps

    l0 = server.be.launches
    t0 = time.perf_counter()
    res = server.authenticate(keys[3], probe_ct, rec.template_ct, enc_bound)
    jax.block_until_ready((res.enc_b, res.enc_y))
    t_auth = time.perf_counter() - t0
    levels = server.be.launches - l0
    y = client.prove(res.enc_y)
    verdict = server.verify_proof(res, y)
    b = int(client.decrypt_word(res.enc_b))
    want_b = mirror_decision(templates[0], probe, bound)
    want_y = int(res.r1) if want_b else (-int(res.r0)) % (1 << proto.bitsize)
    log(f"[protocol] authenticate: {t_auth:.1f}s, {levels} bootstrap launches "
        f"({t_auth / levels * 1e3:.1f} ms per level), Function_f "
        f"{gates_f} gate bootstraps; b={b} (mirror {want_b}) y={int(y)} "
        f"(mirror {want_y}) is_match={bool(verdict['is_match'])}")
    if (b, int(y), bool(verdict["is_match"])) != (want_b, want_y, not want_b):
        raise SystemExit("authenticate disagrees with the plaintext mirror")

    t_ct = client.encrypt_vector(keys[4], templates)
    l0 = server.be.launches
    t0 = time.perf_counter()
    words = jax.block_until_ready(server.identify(probe_ct, t_ct, enc_bound))
    t_id = time.perf_counter() - t0
    got = client.decrypt_word(words)
    want = [mirror_decision(t, probe, bound) for t in templates]
    log(f"[protocol] identify over {len(templates)} templates: {t_id:.1f}s, "
        f"{server.be.launches - l0} launches, {gates_f * len(templates)} gate "
        f"bootstraps; b={got.tolist()} (mirror {want}); peak_bytes_in_use "
        f"{peak_bytes(dev)}")
    if got.tolist() != want:
        raise SystemExit("identify disagrees with the plaintext mirror")


# ------------------------------------------------------------------ phase 5
def bit_equal(x, y) -> bool:
    return (np.array_equal(np.asarray(x.a), np.asarray(y.a))
            and np.array_equal(np.asarray(x.b), np.asarray(y.b)))


def timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def check_ring_tp4(ring: str, devices, seed: int) -> None:
    """tp=4 ring-dimension bootstrap == the one-card bootstrap, decoding."""
    from peba1 import gates
    from peba1.ops import bootstrap as bs
    from peba1.parallel import mesh as pmesh
    from peba1.parallel import shard as pshard

    sk, ck = keygen(ring, seed)
    bits = jnp.asarray(np.random.default_rng(seed).integers(0, 2, 64))
    ct = gates.encrypt_bits(jax.random.PRNGKey(seed), sk, bits)
    mu = jnp.int32(gates.MU_1_8)
    one = jax.block_until_ready(jax.jit(bs.bootstrap)(ck, ct, mu))
    mesh = pmesh.make_mesh(n_dp=1, n_tp=4, devices=devices)
    four = jax.block_until_ready(pshard.sharded_bootstrap_ringtp(mesh, ck, ct, mu))
    same = bit_equal(one, four)
    ok = bool((np.asarray(gates.decrypt_bits(four, sk)) == np.asarray(bits)).all())
    log(f"[four-cards] {ring} tp=4 bootstrap (B=64): bit-equal to one card "
        f"{same}; decodes {ok}")
    if not (same and ok):
        raise SystemExit("tp=4 ring bootstrap differs from one card or input")


def check_four_cards(name: str = "peba1_128_t2", ring: str = "ring_2048_fast",
                     proto=None, seed: int = 13) -> None:
    """dp=4 identification of 8 templates and the tp=4 ring bootstrap, each
    against its one-card run.  The one-card identification and the ring
    check run in worker threads while the dp=4 identification runs here:
    all are bound by per-step dispatch, so they overlap instead of queueing
    (their times are therefore concurrent, not standalone)."""
    from concurrent.futures import ThreadPoolExecutor

    from jax.sharding import NamedSharding, PartitionSpec

    from peba1.params import PEBA1_PROTOCOL
    from peba1.parallel import mesh as pmesh
    from peba1.parallel import shard as pshard
    from peba1.protocol import ClientDevice, Server

    devices = jax.devices()[:4]
    if len(devices) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {len(devices)}")
    proto = proto or PEBA1_PROTOCOL
    sk, ck = keygen(name, seed)
    client, server = ClientDevice(7, sk, ck, proto), Server(ck, proto)
    probe, templates = protocol_vectors(np.random.default_rng(seed), 8,
                                        proto.nslots, proto.bitsize)
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    probe_ct = client.encrypt_vector(k[0], probe)
    t_ct = client.encrypt_vector(k[1], templates)
    enc_bound = client.encrypt_word(k[2], proto.bound_match, proto.max_bitsize)
    mesh = pmesh.make_mesh(n_dp=4, n_tp=1, devices=devices)
    # The cloud key is replicated onto the mesh once, not per launch.
    server4 = Server(jax.device_put(ck, NamedSharding(mesh, PartitionSpec())),
                     proto)
    with ThreadPoolExecutor(max_workers=2) as pool:
        one_future = pool.submit(timed, server.identify, probe_ct, t_ct, enc_bound)
        ring_future = pool.submit(check_ring_tp4, ring, devices, seed)
        four, t_four = timed(pshard.gspmd_identify, mesh, server4, probe_ct,
                             t_ct, enc_bound)
        one, t_one = one_future.result()
        ring_future.result()
    same = bit_equal(one, four)
    got = client.decrypt_word(four).tolist()
    want = [mirror_decision(t, probe, proto.bound_match) for t in templates]
    log(f"[four-cards] identify 8 templates at {proto.nslots}x{proto.bitsize}: "
        f"one card {t_one:.1f}s, dp=4 {t_four:.1f}s (concurrent); bit-equal "
        f"{same}; b={got} (mirror {want}); peak_bytes_in_use per device "
        f"{[peak_bytes(d) for d in devices]}")
    if not same or got != want:
        raise SystemExit("dp=4 identification differs from one card or mirror")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    devices = require_gpu()
    from peba1.utils.cache import enable_compile_cache
    enable_compile_cache()
    d0 = devices[0]
    log(f"[device] {d0.platform} {d0.device_kind} x{len(devices)}; "
        f"nvidia-smi: {card_name_and_power_limit()}")
    phases = ([("four-cards", check_four_cards)] if args.four_cards else [
        ("kernels", lambda: [check_step_extproduct(n)
                             for n in ("peba1_128_t2", "ring_2048_fast")]),
        ("engine", lambda: [check_chain(n) for n in CHAIN_LATTICES]),
        ("protocol", check_protocol),
    ])
    log(f"[device] {time.perf_counter() - t0:.1f}s")
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        log(f"[{name}] phase done in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
