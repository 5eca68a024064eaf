"""Headline benchmark: gate bootstraps/s on one device (BASELINE.json north star).

Runs CHAINED batched AND-gate bootstraps at lambda=128 parameters (default
preset peba1_128_t2: n=630, k*N=1024 as a rank-2 module over N=512 -- same
total key dimension and noise rates as the reference's TFHE v1.x set; see
peba1/params.py), checks decryption of the chained output, and prints ONE
JSON line:

  {"metric": "gate_bootstraps_per_s", "value": ..., ...}

Timing: one warm-up call compiles, then the min over REPS calls of a
`steps`-long chain, each ending in block_until_ready.  Chaining (each
bootstrap's output feeds the next AND(x,x)=x) serializes the steps and
mirrors real circuit composition.  vs_baseline is against the BASELINE.md
target of >=10^4 bootstraps/s.  Environment: PEBA1_BENCH_PARAMS,
PEBA1_BENCH_BATCH, PEBA1_BENCH_STEPS, PEBA1_BENCH_REPS.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from peba1 import gates, keys
from peba1.params import PRESETS
from peba1.utils.cache import enable_compile_cache

B = int(os.environ.get("PEBA1_BENCH_BATCH", "8192"))
STEPS = int(os.environ.get("PEBA1_BENCH_STEPS", "4"))
REPS = int(os.environ.get("PEBA1_BENCH_REPS", "3"))
PARAMS = os.environ.get("PEBA1_BENCH_PARAMS", "peba1_128_t2")


def main():
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    sk, ck = jax.block_until_ready(jax.jit(keys.keygen, static_argnames=("params",))(
        jax.random.PRNGKey(0), params=PRESETS[PARAMS]))
    bits = jnp.asarray(np.random.default_rng(0).integers(0, 2, B))
    ct = jax.block_until_ready(gates.encrypt_bits(jax.random.PRNGKey(1), sk, bits))
    jax.block_until_ready(gates.and_chain(ck, ct, STEPS))  # compile + warm
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = jax.block_until_ready(gates.and_chain(ck, ct, STEPS))
        best = min(best, time.perf_counter() - t0)
    value = B * STEPS / best
    correct = float((np.asarray(gates.decrypt_bits(out, sk)) == np.asarray(bits)).mean())
    print(json.dumps({
        "metric": "gate_bootstraps_per_s",
        "value": value,
        "unit": "bootstraps/s",
        "vs_baseline": value / 10_000.0,
        "batch": B,
        "chain_steps": STEPS,
        "seconds": best,
        "batch_correct_frac": correct,
        "params": PARAMS,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
