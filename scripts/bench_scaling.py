"""Multi-device scaling benchmark (BASELINE.json config 5).

Weak scaling of the sharded protocol paths: fixed per-device work, mesh grown
over the dp axis; efficiency(n) = t(1) / t(n) (ideal weak scaling keeps wall
time flat).  Two modes:

  --mode bootstrap   sharded_bootstrap (per-device gate-bootstrap batch)
  --mode identify    sharded_identify (per-device template shard of the full
                     encrypted-distance + threshold circuit -- the config-5
                     workload shape)

On a four-card host this exercises the collectives between cards; it can
also run on the virtual CPU mesh (--platform cpu --virtual-devices 8) to
validate the harness and the sharded programs, where times reflect host-core
contention, not interconnect (caveat recorded in the JSON).

Per mesh size, `--reps` timed runs on fresh inputs, each ending in
block_until_ready, min taken.

Emits one JSON line with per-mesh-size timings and efficiencies.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="toy")
    ap.add_argument("--mode", choices=["bootstrap", "identify"],
                    default="bootstrap")
    ap.add_argument("--per-device-batch", type=int, default=64,
                    help="gate bootstraps per device (bootstrap mode)")
    ap.add_argument("--per-device-templates", type=int, default=2,
                    help="templates per device (identify mode)")
    ap.add_argument("--nslots", type=int, default=2)
    ap.add_argument("--bitsize", type=int, default=3)
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--n-tp", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--virtual-devices", type=int, default=0,
                    help="force N virtual CPU devices (sets XLA_FLAGS; must "
                         "be first JAX use in the process)")
    args = ap.parse_args(argv)

    if args.virtual_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual_devices}"
        ).strip()
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from peba1 import circuits as cc
    from peba1 import gates, keys
    from peba1.backends import CipherBackend
    from peba1.params import PRESETS
    from peba1.parallel import mesh as pmesh
    from peba1.parallel import shard as pshard
    from peba1.utils.artifacts import atomic_json
    from peba1.utils.bits import int_to_bits
    from peba1.utils.cache import enable_compile_cache

    enable_compile_cache()
    p = PRESETS[args.params]
    sk, ck = jax.block_until_ready(jax.jit(keys.keygen, static_argnames=("params",))(
        jax.random.PRNGKey(0), params=p))

    sizes = [int(s) for s in args.sizes.split(",")]
    devices = jax.devices()
    rng = np.random.default_rng(0)
    times = {}

    def run_bootstrap(m, n, seed):
        batch = args.per_device_batch * n
        bits = jnp.asarray(rng.integers(0, 2, batch))
        ct = jax.block_until_ready(
            gates.encrypt_bits(jax.random.PRNGKey(seed), sk, bits))
        t0 = time.time()
        out = jax.block_until_ready(
            pshard.sharded_bootstrap(m, ck, ct, jnp.int32(gates.MU_1_8)))
        dt = time.time() - t0
        got = np.asarray(gates.decrypt_bits(out, sk))
        assert (got == np.asarray(bits)).all(), f"wrong bits at n={n}"
        return dt

    def run_identify(m, n, seed):
        nt = args.per_device_templates * n
        hi = (1 << args.bitsize) - 1
        # Nonzero slot values only (full domain [1, 2^bitsize - 1]): a zero
        # operand triggers the faithful sub_abs forced-sign quirk and the
        # naive plaintext expectation below would not apply (same domain as
        # __graft_entry__.dryrun and tests/test_parallel.py).
        tmpl = rng.integers(1, hi + 1, (nt, args.nslots))
        probe = tmpl[nt // 2]
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        t_ct = gates.encrypt_bits(k1, sk, int_to_bits(tmpl, args.bitsize))
        p_ct = gates.encrypt_bits(k2, sk, int_to_bits(probe, args.bitsize))
        be = CipherBackend(ck)
        bound = cc.const_word(be, 2 * args.nslots, 3 * args.bitsize)
        jax.block_until_ready((t_ct, p_ct, bound))
        t0 = time.time()
        out = jax.block_until_ready(
            pshard.sharded_identify(m, ck, p_ct, t_ct, bound, args.bitsize))
        dt = time.time() - t0
        d = ((tmpl - probe) ** 2).sum(1)
        from peba1.utils.bits import bits_to_int
        got = bits_to_int(np.asarray(gates.decrypt_bits(out, sk)))
        want = (d > 2 * args.nslots).astype(int)
        assert (got == want).all(), f"wrong verdicts at n={n}"
        return dt

    def make_record():
        base = times[min(times)]
        return {
            "metric": f"weak_scaling_efficiency_{args.mode}",
            "unit": "t1/tn (1.0 = ideal)",
            "mode": args.mode,
            "per_device_batch": args.per_device_batch,
            "per_device_templates": args.per_device_templates,
            "params": args.params,
            "reps": args.reps,
            "times_s": {str(k): round(v, 4) for k, v in times.items()},
            "efficiency": {str(k): round(base / v, 4) for k, v in times.items()},
            "virtual_cpu_mesh": bool(args.virtual_devices),
            "caveat": ("virtual CPU mesh: times include host-core contention, "
                       "not interconnect" if args.virtual_devices else None),
            "device": str(jax.devices()[0]),
        }

    run = {"bootstrap": run_bootstrap, "identify": run_identify}[args.mode]
    for n in sizes:
        if n * args.n_tp > len(devices):
            print(f"skip n={n}: only {len(devices)} devices", file=sys.stderr)
            continue
        m = pmesh.make_mesh(n_dp=n, n_tp=args.n_tp, devices=devices)
        run(m, n, seed=1000 + n)  # warm/compile for this mesh shape
        best = min(run(m, n, seed=2000 + 10 * n + r) for r in range(args.reps))
        times[n] = best
        print(f"n={n}: {best:.3f}s (min of {args.reps})",
              file=sys.stderr, flush=True)
        # Incremental artifact: a timeout/crash mid-sweep keeps the sizes
        # measured so far (identify mode is hours on the 2-core virtual mesh).
        if args.out:
            atomic_json(args.out, make_record())

    rec = make_record()
    print(json.dumps(rec))
    if args.out:
        atomic_json(args.out, rec)


if __name__ == "__main__":
    main()
