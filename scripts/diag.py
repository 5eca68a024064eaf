"""On-device diagnostics for peba1.

    python scripts/diag.py throughput [preset ...]   chained bootstraps/s
    python scripts/diag.py noise                     post-bootstrap phase error
    python scripts/diag.py campaign --params P --out NOISE_P.json
    python scripts/diag.py golden [--out FILE]       cipher golden-corpus run

Timing is host wall clock around work that ends in block_until_ready, after
a warm-up call that compiles.  Every record names the device, and on a GPU
the card's name and power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax
import jax.numpy as jnp
import numpy as np

from peba1 import gates, keys, lwe
from peba1.ops import bootstrap as bs
from peba1.params import PEBA1_128, PRESETS
from peba1.utils.artifacts import atomic_json
from peba1.utils.cache import enable_compile_cache

MU = gates.MU_1_8


def device_name() -> str:
    """JAX's device kind, plus nvidia-smi's name and power limit on a GPU."""
    d = jax.devices()[0]
    name = f"{d.platform} {d.device_kind}"
    if d.platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        name += f" ({smi.stdout.strip().splitlines()[0]})"
    return name


def _keygen(P):
    kg = jax.jit(keys.keygen, static_argnames=("params",))
    t0 = time.time()
    sk, ck = jax.block_until_ready(kg(jax.random.PRNGKey(0), params=P))
    return sk, ck, time.time() - t0


# ---------------------------------------------------------------- throughput
def mode_throughput(args):
    """Warm chained-bootstrap rate per preset at one batch size."""
    B, S = args.batch, args.steps
    for name in (args.presets or ["peba1_128_t2"]):
        sk, ck, dt = _keygen(PRESETS[name])
        bits = jnp.asarray(np.random.default_rng(0).integers(0, 2, B))
        ct = gates.encrypt_bits(jax.random.PRNGKey(1), sk, bits)
        t0 = time.time()
        jax.block_until_ready(gates.and_chain(ck, ct, S))
        cold = time.time() - t0
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.time()
            out = jax.block_until_ready(gates.and_chain(ck, ct, S))
            best = min(best, time.time() - t0)
        ok = float((np.asarray(gates.decrypt_bits(out, sk)) == np.asarray(bits)).mean())
        print(json.dumps({"preset": name, "batch": B, "chain_steps": S,
                          "gate_bootstraps_per_s": B * S / best,
                          "seconds": best, "first_call_seconds": cold,
                          "keygen_seconds": dt, "chain_correct_frac": ok,
                          "device": device_name()}), flush=True)


# --------------------------------------------------------------------- noise
def _phase_err(a, b, key_bits, bits):
    """Signed phase error vs +-mu, as fraction of torus."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    key_bits = np.asarray(key_bits, np.int64)
    phase = (b - a @ key_bits) & 0xFFFFFFFF
    want = np.where(np.asarray(bits) == 1, MU, (-MU) & 0xFFFFFFFF)
    e = (phase - want) & 0xFFFFFFFF
    e = np.where(e >= 2**31, e - 2**32, e).astype(np.float64) / 2**32
    return e


def _noise_report(name, e):
    errs = int((np.abs(e) > 1 / 16).sum())
    print(f"  {name}: stdev={e.std():.6f} max|e|={np.abs(e).max():.6f} "
          f"mean={e.mean():.2e} decode_errs={errs}/{e.size}", flush=True)
    return {"stdev": float(e.std()), "max": float(np.abs(e).max()),
            "decode_errs": errs, "n": int(e.size)}


def mode_noise(args):
    B = args.batch
    bases = [dict(l=3, bgbit=7, bk_body_limbs=4),
             dict(l=2, bgbit=8, bk_body_limbs=3),
             dict(l=2, bgbit=8, bk_body_limbs=3, k=2, N=512)]
    for kw in bases:
        P = dataclasses.replace(PEBA1_128, **kw)
        sk, ck, dt = _keygen(P)
        print(f"keygen {kw}: {dt:.0f}s", flush=True)
        bits = np.random.default_rng(0).integers(0, 2, B)
        ct = gates.encrypt_bits(jax.random.PRNGKey(1), sk, jnp.asarray(bits))
        pre = lwe.Lwe(ct.a * 2, ct.b * 2 + jnp.int32(-MU))
        a_ext, b_ext = jax.block_until_ready(
            jax.jit(bs.bootstrap_wo_ks)(ck, pre, jnp.int32(MU)))
        out = jax.block_until_ready(jax.jit(bs.bootstrap)(ck, pre, jnp.int32(MU)))
        _noise_report("pre-ks ", _phase_err(
            a_ext, b_ext, np.asarray(sk.extracted_key), bits))
        _noise_report("post-ks", _phase_err(
            out.a, out.b, np.asarray(sk.lwe_key), bits))


# ------------------------------------------------------------------ campaign
def mode_campaign(args):
    """Statistical per-gate error campaign at real parameters on the device.

    Runs `steps` CHAINED batched identity bootstraps (AND(x,x) = x) on
    `batch` fresh encryptions -- batch*steps serialized gate evaluations,
    every intermediate output feeding the next gate, so any mid-chain decode
    error flips downstream bits and lands in `chain_error_frac`.  The final
    outputs' phase-error distribution (under the small key) is the
    steady-state per-gate error; the JSON record holds sigma, max|e|, the
    1/16 decoding margin in sigma units, and the implied Gaussian per-gate
    error bound.  tests/test_noise.py pins the committed records.
    """
    P = PRESETS[args.params]
    sk, ck, dt = _keygen(P)
    print(f"keygen {dt:.0f}s", flush=True)
    B, cs = args.batch, min(args.chunk_steps, args.steps)
    n_chunks = -(-args.steps // cs)
    bits = np.random.default_rng(1).integers(0, 2, B)
    ct = gates.encrypt_bits(jax.random.PRNGKey(321), sk, jnp.asarray(bits))
    t0 = time.time()
    for i in range(n_chunks):
        ct = jax.block_until_ready(gates.and_chain(ck, ct, cs))
        print(f"  chunk {i + 1}/{n_chunks} ({(i + 1) * cs * B / 1e6:.2f}M gates, "
              f"{time.time() - t0:.0f}s)", flush=True)
    seconds = time.time() - t0
    e = _phase_err(ct.a, ct.b, np.asarray(sk.lwe_key), bits)
    got = np.asarray(gates.decrypt_bits(ct, sk)) == bits
    sigma, margin = float(e.std()), 1 / 16
    rec = {
        "metric": "chained_gate_error_campaign",
        "params": args.params,
        "gates": B * cs * n_chunks,
        "batch": B, "chain_steps": cs * n_chunks,
        "chain_error_frac": float(1 - got.mean()),
        "phase_sigma": round(sigma, 6),
        "phase_max_abs": round(float(np.abs(e).max()), 6),
        "margin": margin,
        "margin_sigmas": round(margin / sigma, 2),
        "gaussian_per_gate_error_bound": float(
            f"{math.erfc(margin / sigma / math.sqrt(2)):.3e}"),
        "final_decode_errs": int((np.abs(e) > margin).sum()),
        "seconds": round(seconds, 1),
        "device": device_name(),
    }
    print(json.dumps(rec), flush=True)
    if args.out:
        atomic_json(args.out, rec)


# -------------------------------------------------------------------- golden
def mode_golden(args):
    """Evaluate the frozen golden conformance corpus with the CIPHER circuit
    at full protocol width on the device; write the decision-equality record."""
    from peba1 import conformance as cf

    corpus = cf.load_corpus(args.corpus)
    P = PRESETS[args.params]
    sk, ck, dt = _keygen(P)
    print(f"keygen {dt:.0f}s; corpus n={corpus['n_cases']} "
          f"nslots={corpus['nslots']} bitsize={corpus['bitsize']}", flush=True)
    t0 = time.time()
    got_b, got_y = cf.eval_cipher(sk, ck, corpus, jax.random.PRNGKey(9),
                                  batch=args.corpus_batch)
    dt = time.time() - t0
    _, _, _, _, _, want_b, want_y = cf.corpus_arrays(corpus)
    rec = {
        "metric": "golden_corpus_decision_equality",
        "params": args.params,
        "n_cases": int(len(want_b)),
        "nslots": corpus["nslots"], "bitsize": corpus["bitsize"],
        "b_equal": int((got_b == want_b).sum()),
        "y_equal": int((got_y == want_y).sum()),
        "all_equal": bool((got_b == want_b).all() and (got_y == want_y).all()),
        "seconds": round(dt, 1),
        "device": device_name(),
    }
    print(json.dumps(rec), flush=True)
    if args.out:
        atomic_json(args.out, rec, indent=None)
    if not rec["all_equal"]:
        sys.exit(1)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)
    t = sub.add_parser("throughput")
    t.add_argument("presets", nargs="*", choices=[[], *PRESETS],
                   metavar="preset")
    t.add_argument("--batch", type=int, default=8192)
    t.add_argument("--steps", type=int, default=4,
                   help="chained bootstraps per timed call")
    t.add_argument("--reps", type=int, default=3,
                   help="timed repetitions (min taken)")
    n = sub.add_parser("noise")
    n.add_argument("--batch", type=int, default=4096)
    cp = sub.add_parser("campaign")
    cp.add_argument("--params", default="peba1_128_t2", choices=sorted(PRESETS))
    cp.add_argument("--batch", type=int, default=8192)
    cp.add_argument("--steps", type=int, default=128)
    cp.add_argument("--chunk-steps", type=int, default=16,
                    help="chained bootstraps per dispatch")
    cp.add_argument("--out", default=None)
    g = sub.add_parser("golden")
    g.add_argument("--params", default="peba1_128_t2", choices=sorted(PRESETS))
    g.add_argument("--corpus", default=os.path.join(
        os.path.dirname(__file__), "..", "tests", "data", "golden_corpus.json"))
    g.add_argument("--corpus-batch", type=int, default=16)
    g.add_argument("--out", default=None)
    args = ap.parse_args()
    enable_compile_cache()
    {"throughput": mode_throughput, "noise": mode_noise,
     "campaign": mode_campaign, "golden": mode_golden}[args.mode](args)


if __name__ == "__main__":
    main()
