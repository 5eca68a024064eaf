"""Reference-style driver: reproduces the peba1 binary's self-test suite.

Equivalent of /root/reference/src/main.cpp:10-609 -- key setup,
test-vector generation, encrypt/decrypt round-trip gate, plaintext suite,
ciphertext suite, and the full encrypted protocol run, with per-phase wall
timings.  Where the reference loops 128 times over single ops
(src/main.cpp:102), we run the 128 cases as ONE batch (that is the point).

Run:  python -m peba1 [--params toy|peba1_128] [--nslots N] [--bitsize B]
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from . import circuits as cc
from . import clear, gates, keys
from .backends import CipherBackend
from .params import PRESETS, ProtocolParams
from .protocol import ClientDevice, Server
from .utils.cache import enable_compile_cache
from .utils.bits import bits_to_int, int_to_bits


class _Timer:
    def __init__(self):
        self.t = time.time()

    def lap(self) -> float:
        now = time.time()
        dt = now - self.t
        self.t = now
        return dt


def run(params_name: str = "toy", nslots: int = 128, bitsize: int = 8,
        loop: int = 128, seed: int = 42, skip_cipher_suite: bool = False) -> dict:
    results: dict = {}
    tfhe = PRESETS[params_name]
    proto = ProtocolParams(nslots=nslots, bitsize=bitsize,
                           max_bitsize=3 * bitsize, mul_width=3 * bitsize - 1,
                           bound_match=nslots * 2)
    tm = _Timer()

    # --- key/param setup (src/main.cpp:20-23) ---------------------------
    key = jax.random.PRNGKey(seed)
    k_gen, k_enc, k_auth = jax.random.split(key, 3)
    # Jitted keygen, like every other harness: XLA plans the buffer reuse of
    # the key intermediates instead of eager ops keeping them alive.
    sk, ck = jax.jit(keys.keygen, static_argnames=("params",))(
        k_gen, params=tfhe)
    jax.block_until_ready(ck)
    print(f"[keys] generated ({params_name}) in {tm.lap():.1f}s")

    # --- test vectors (src/main.cpp:30-42) ------------------------------
    rng = np.random.default_rng(seed)
    hi = (1 << bitsize) - 1
    template = rng.integers(1, hi, nslots)
    sample_true = template + 1                      # ED = nslots
    sample_false = rng.integers(1, hi + 1, nslots)
    print(f"[vectors] nslots={nslots} bitsize={bitsize}")

    # --- enc/dec round-trip gate (src/main.cpp:51-94) -------------------
    client = ClientDevice(7, sk, ck, proto)
    server = Server(ck, proto)
    ks = jax.random.split(k_enc, 4)
    enc_template = client.encrypt_vector(ks[0], template)
    enc_true = client.encrypt_vector(ks[1], sample_true)
    enc_false = client.encrypt_vector(ks[2], sample_false)
    ok = ((client.decrypt_word(enc_template) == template).all()
          and (client.decrypt_word(enc_true) == sample_true).all()
          and (client.decrypt_word(enc_false) == sample_false).all())
    results["roundtrip"] = bool(ok)
    print(f"[enc/dec] correctness {'succeeds' if ok else 'FAILS'} ({tm.lap():.1f}s)")
    if not ok:
        raise SystemExit("encryption round-trip failed")

    # --- plaintext suite (src/main.cpp:107-290) -------------------------
    # The reference loops `loop`=128 times per op over fresh random values
    # (src/main.cpp:102,124-127); here each op's 128 cases run as one batch.
    t64 = template.astype(np.uint64)
    s64 = sample_true.astype(np.uint64)
    px = rng.integers(1, hi + 1, loop).astype(np.uint64)
    py = rng.integers(1, hi + 1, loop).astype(np.uint64)
    checks = {
        "add": (clear.add_nbit(px, py, 64) == px + py).mean(),
        "twos_complement": (clear.twos_complement(px, 64) == (-px)).mean(),
        "abs": (clear.abs_(px, 64) == px).mean(),
        "sub": (clear.sub_nbit(px, py, 64) == np.abs(px.astype(np.int64) - py.astype(np.int64)).astype(np.uint64)).mean(),
        "multiply": (clear.multiply(px, py, bitsize) == px * py).mean(),
        "manhattan": float(clear.manhattan_distance_bitwise(t64, s64, 64) == clear.manhattan_distance(template, sample_true)),
        "euclidean": float(clear.euclidean_distance_bitwise(t64, s64, 64) == clear.euclidean_distance(template, sample_true)),
    }
    results["plaintext_suite"] = {k: float(v) for k, v in checks.items()}
    all_ok = all(v == 1.0 for v in checks.values())
    print(f"[plaintext suite] {'all pass' if all_ok else checks} "
          f"(loop={loop}, {tm.lap():.3f}s)")

    bound = int(proto.bound_match)
    f_clear = clear.function_f_clear(t64, s64, bound, 64)
    y_clear = clear.function_g_clear(f_clear, 17, 99, 64)
    results["protocol_clear"] = {"f": int(f_clear), "y==r1": bool(y_clear == 99)}
    print(f"[plaintext protocol] f={int(f_clear)} (ED={int(clear.euclidean_distance(template, sample_true))} vs bound={bound})")

    # --- ciphertext suite (src/main.cpp:296-465), batched ---------------
    # Per-op parity with the reference suite: ADDNbit (:311),
    # TwoSComplement (:344), ABS (:370), SUBNbit (:408), Multiply (:442),
    # minimum (exercised via the comparator), HE Manhattan (:487) and
    # HE Euclidean (:502) -- each op's `loop` random cases as ONE batch,
    # decrypted and checked against the plaintext mirror, timed per phase.
    if not skip_cipher_suite:
        be = CipherBackend(ck)
        cx = rng.integers(1, hi + 1, loop)
        cy = rng.integers(1, hi + 1, loop)
        kc = jax.random.split(jax.random.fold_in(k_enc, 77), 2)
        ex = client.encrypt_vector(kc[0], cx)
        ey = client.encrypt_vector(kc[1], cy)
        suite: dict = {}

        def dec(ct):
            return bits_to_int(np.asarray(gates.decrypt_bits(ct, sk)))

        def record(name, got, want):
            ok = (got == np.asarray(want, got.dtype)).mean()
            dt = tm.lap()
            suite[name] = {"correct": float(ok), "seconds": round(dt, 3)}
            print(f"[cipher] {name}: {ok*100:.1f}% ({dt:.1f}s, "
                  f"{be.launches} launches)")

        mod = 1 << bitsize
        s, _ = cc.add_n(be, ex, ey, bitsize)
        record("add", dec(s), (cx + cy) % mod)
        tc = cc.twos_complement(be, ex, bitsize)
        record("twos_complement", dec(tc), (-cx) % mod)
        ab = cc.abs_n(be, ex, bitsize)
        record("abs", dec(ab), np.where(cx < mod // 2, cx, mod - cx))
        sub = cc.sub_abs(be, ex, ey, bitsize)
        record("sub_abs", dec(sub), np.abs(cx.astype(int) - cy.astype(int)))
        mul = cc.multiply(be, ex, ey, bitsize, length=proto.mul_width)
        record("multiply", dec(mul),
               (cx.astype(np.int64) * cy) % (1 << proto.mul_width))
        mn, gt = cc.minimum(be, ex, ey, bitsize)
        mn_ok = dec(mn) == np.minimum(cx, cy)
        gt_ok = dec(gt) == (cx > cy).astype(np.int64)
        record("minimum", (mn_ok & gt_ok), True)
        man = cc.manhattan(be, enc_true, enc_template, bitsize)
        # bitsize-wide accumulator: faithful overflow quirk (src/Math.cpp:291)
        record("he_manhattan", dec(man[..., :bitsize]),
               int(clear.manhattan_distance(template, sample_true)) % mod)
        euc = cc.euclidean(be, enc_true, enc_template, bitsize,
                           max_bitsize=proto.max_bitsize)
        record("he_euclidean", dec(euc),
               int(clear.euclidean_distance(template, sample_true))
               % (1 << (proto.max_bitsize - 1)))
        results["cipher_suite"] = suite

    # --- encrypted protocol (src/main.cpp:513-586) ----------------------
    rec = client.enroll(jax.random.fold_in(k_enc, 9), template)
    server.register(rec)
    enc_bound = client.encrypt_word(jax.random.fold_in(k_enc, 10), bound, 3 * bitsize)
    t0 = time.time()
    res = server.authenticate(k_auth, enc_true, rec.template_ct, enc_bound)
    jax.block_until_ready(res.enc_y.b)
    t_auth = time.time() - t0
    y = client.prove(res.enc_y)
    b = int(client.decrypt_word(res.enc_b))
    v = server.verify_proof(res, y)
    ed = int(clear.euclidean_distance(template, sample_true))
    results["protocol"] = {
        "ed": ed, "bound": bound, "b": b,
        "y": int(y), "r0": int(res.r0), "r1": int(res.r1),
        "reference_verdict(y==r1)": bool(v["reference_verdict"]),
        "is_match": bool(v["is_match"]),
        "seconds": t_auth,
    }
    expect_b = 1 if ed > bound else 0
    status = "OK" if b == expect_b else "MISMATCH"
    print(f"[protocol] ED={ed} bound={bound} b={b} ({status}); y={int(y)} "
          f"r0={int(res.r0)} r1={int(res.r1)}; Function_f+g in {t_auth:.1f}s")
    print(f"[protocol] faithful driver verdict (y==r1): {bool(v['reference_verdict'])}; "
          f"semantic is_match: {bool(v['is_match'])}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="PEBA1 reference-style driver")
    # Defaults mirror the reference binary's constants: lambda=128 params
    # (src/main.cpp:20-21), nslots=128, bitsize=8 (src/main.cpp:30-32).
    # For a quick CPU smoke run use --params toy --nslots 8 --bitsize 4.
    ap.add_argument("--params", default="peba1_128_t2",
                    choices=sorted(PRESETS))
    ap.add_argument("--nslots", type=int, default=128)
    ap.add_argument("--bitsize", type=int, default=8)
    ap.add_argument("--loop", type=int, default=128)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--skip-cipher-suite", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write the results dict as a JSON artifact")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="force a JAX backend (default: JAX's own choice)")
    args = ap.parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    results = run(args.params, args.nslots, args.bitsize, args.loop, args.seed,
                  args.skip_cipher_suite)
    if args.out:
        import json

        results["params"] = args.params
        results["nslots"] = args.nslots
        results["bitsize"] = args.bitsize
        results["device"] = str(jax.devices()[0])
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)


if __name__ == "__main__":
    main()
