"""Protocol-level benchmark: encrypted matches/s (BASELINE.json configs 2/3).

Config 2: B independent 1:1 matches (probe vs template, Function_f + _g),
          all pairs batched into the same levelized bootstrap launches.
Config 3: 1:N identification -- one probe vs N templates, threshold mode
          (Server.identify) or tournament-argmin mode (identify_argmin).

Timing is end-to-end wall clock from the first launch to block_until_ready
on the decision words.  Emits one JSON line per run.

The circuit executes as a sequence of eager levelized launches (one jitted
bootstrap batch per circuit level, CipherBackend.launches counts them), so
there is no giant whole-protocol XLA graph to compile; each distinct batch
shape compiles once and is cached (peba1.utils.cache).

Usage:
  python scripts/bench_matches.py --config pairs --pairs 256 --nslots 8
  python scripts/bench_matches.py --config identify --n-templates 64
  python scripts/bench_matches.py --config argmin --n-templates 64

Full-scale config 2 (--pairs 256 --nslots 128 --bitsize 8) is ~5.6e7 gate
bootstraps.  Scaled runs measure the same code path; gates/match scales
~linearly in nslots, so matches/s at full scale =
measured_bootstraps_per_s / gates_per_full_match.

Memory envelope: at full width the encrypted intermediate words of the
batched Euclidean distance are ~(pairs*nslots) x width x (n+1) int32; --split
runs the pairs as sequential sub-batches where one batch would not fit.
"""

import argparse
import faulthandler
import json
import os
import signal
import sys
import time

# SIGUSR1 -> dump all thread stacks to stderr (stall diagnosis).
faulthandler.register(signal.SIGUSR1)
faulthandler.dump_traceback_later(1800, repeat=True)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax

import jax.numpy as jnp
import numpy as np

from peba1 import keys
from peba1.params import PRESETS, ProtocolParams
from peba1.protocol import ClientDevice, Server
from peba1.utils.cache import enable_compile_cache
from peba1.utils.logging import stderr_log

enable_compile_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=["pairs", "identify", "argmin"],
                    default="pairs")
    # Default: the t2 lattice, whose chained-gate campaign record is
    # committed (NOISE_peba1_128_t2.json).
    ap.add_argument("--params", default="peba1_128_t2",
                    choices=sorted(PRESETS))
    ap.add_argument("--pairs", type=int, default=256)
    ap.add_argument("--split", type=int, default=1,
                    help="run the pairs batch as this many sequential "
                         "sub-batches (memory cap; see docstring)")
    ap.add_argument("--n-templates", type=int, default=64)
    ap.add_argument("--nslots", type=int, default=128)
    ap.add_argument("--bitsize", type=int, default=8)
    ap.add_argument("--platform", default=None, help="e.g. cpu to force local")
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    args = ap.parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    log = stderr_log(bench="matches", config=args.config)
    proto = ProtocolParams(
        nslots=args.nslots, bitsize=args.bitsize,
        max_bitsize=3 * args.bitsize, mul_width=3 * args.bitsize - 1,
        bound_match=args.nslots * 2)
    tfhe = PRESETS[args.params]

    k = jax.random.PRNGKey(0)
    kg, k1, k2, k3, k4 = jax.random.split(k, 5)
    with log.timer("keygen"):
        sk, ck = jax.block_until_ready(
            jax.jit(keys.keygen, static_argnames=("params",))(kg, params=tfhe))
    client = ClientDevice(7, sk, ck, proto)
    server = Server(ck, proto)

    rng = np.random.default_rng(0)
    hi = (1 << args.bitsize) - 1

    if args.config == "pairs":
        n_items = args.pairs
        templates = rng.integers(1, hi, (args.pairs, args.nslots))
        probes = templates + rng.integers(0, 2, templates.shape)  # near-matches
        with log.timer("encrypt"):
            t_ct = client.encrypt_vector(k1, templates)
            p_ct = client.encrypt_vector(k2, probes)
            bound_ct = client.encrypt_word(
                k3, np.full(args.pairs, proto.bound_match), 3 * args.bitsize)
            jax.block_until_ready(t_ct.b)
        server.be.launches = 0
        # --split S: run the batch as S sequential sub-batches inside ONE
        # timed window.  The memory envelope (module docstring) is set by
        # the encrypted multiply intermediates, which scale with the LIVE
        # sub-batch.
        split = max(1, args.split)
        assert args.pairs % split == 0, "--pairs must divide by --split"
        sub = args.pairs // split
        bs = []
        t0 = time.time()
        for h in range(split):
            sl = slice(h * sub, (h + 1) * sub)
            res = server.authenticate(jax.random.fold_in(k4, h),
                                      p_ct[sl], t_ct[sl], bound_ct[sl])
            jax.block_until_ready((res.enc_b, res.enc_y))
            bs.append(res.enc_b)
            if split > 1:
                print(f"[pairs] sub-batch {h + 1}/{split} done "
                      f"({time.time() - t0:.0f}s)", flush=True)
        dt = time.time() - t0
        # correctness: decrypt and compare against plaintext distances
        from peba1 import lwe as _lwe
        b = client.decrypt_word(_lwe.concatenate(bs, axis=0))
        want = (((probes - templates) ** 2).sum(1) > proto.bound_match).astype(int)
        correct = float((np.asarray(b) == want).mean())
    else:
        n_items = args.n_templates
        templates = rng.integers(1, hi, (args.n_templates, args.nslots))
        probe = templates[3] + 1
        with log.timer("encrypt"):
            t_ct = client.encrypt_vector(k1, templates)
            p_ct = client.encrypt_vector(k2, probe)
            bound_ct = client.encrypt_word(k3, proto.bound_match, 3 * args.bitsize)
            jax.block_until_ready(t_ct.b)
        server.be.launches = 0
        clear_d = ((templates - probe) ** 2).sum(1)
        t0 = time.time()
        if args.config == "identify":
            out = jax.block_until_ready(server.identify(p_ct, t_ct, bound_ct))
            dt = time.time() - t0
            b = client.decrypt_word(out)
            want = (clear_d > proto.bound_match).astype(int)
            correct = float((np.asarray(b) == want).mean())
        else:
            enc_d, enc_i = jax.block_until_ready(
                server.identify_argmin(p_ct, t_ct))
            dt = time.time() - t0
            d = int(client.decrypt_word(enc_d))
            i = int(client.decrypt_word(enc_i))
            correct = float(d == int(clear_d.min()) and i == int(np.argmin(clear_d)))

    rec = {
        "metric": f"encrypted_{args.config}_matches_per_s",
        "value": round(n_items / dt, 4),
        "unit": "matches/s",
        "seconds": round(dt, 2),
        "items": n_items,
        "split": args.split if args.config == "pairs" else None,
        "launches": server.be.launches,
        "nslots": args.nslots,
        "bitsize": args.bitsize,
        "params": args.params,
        "correct_frac": correct,
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(rec))
    if args.out:
        from peba1.utils.artifacts import atomic_json
        atomic_json(args.out, rec)


if __name__ == "__main__":
    main()
