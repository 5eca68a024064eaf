"""Operational-scale 1:N identification sweep (BASELINE config 3).

Drives sweep.IdentifySweep -- the checkpoint/resume engine -- at full
protocol width: one encrypted probe against N enrolled templates, chunked
into batched Server.identify launches, every chunk's encrypted decision
words checkpointed to disk (atomic writes, content-fingerprinted).  Re-run
the same command after an interrupt (Ctrl-C, stall, preemption) and it
resumes at the first missing chunk; the artifact records how many chunks
were computed vs resumed so the resume path is *demonstrated*, not assumed.

Everything is deterministic from --seed: templates, probe, encryption keys.
The artifact (--out) is rewritten atomically after EVERY chunk, so a kill at
any point leaves a valid partial record; on completion the chunks are
collected, decrypted, and verified against the plaintext distances.

  python scripts/sweep_identify.py --n-templates 1024 --chunk 64 \
      --dir runs/sweep --out runs/sweep.json

FINALIZE mode (--finalize): computes NOTHING on any device.  Rebuilds the
client's secret key + plaintext expectations from --seed (keys.secret_keygen
-- no cloud-key precomputation), re-verifies every on-disk chunk's
fingerprint against the manifest, decrypts all completed decisions against
the plaintext distances, and emits the full artifact (decisions_verified,
correct_frac, steady-state rates) for a sweep in ANY state of completion --
so a mid-sweep evidence record is a reproducible command, not hand-edited
JSON.  Rates come from per-chunk `seconds` persisted in the chunk metadata;
for chunks written before that field existed, pass the partial artifacts of
the runs that computed them via --merge-rates.

  python scripts/sweep_identify.py --n-templates 1024 --chunk 32 \
      --dir runs/sweep --finalize --merge-rates runs/sweep.json \
      --out runs/sweep_final.json

Each template costs ~2.2e5 gate bootstraps at full width (SURVEY.md section
3.6; the exact count is measured per run via backends.CountingBackend).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax

import numpy as np

from peba1 import keys, sweep
from peba1.params import PRESETS, ProtocolParams
from peba1.protocol import ClientDevice, Server
from peba1.utils.artifacts import atomic_json
from peba1.utils.cache import enable_compile_cache
from peba1.utils.logging import stderr_log

enable_compile_cache()


def make_inputs(args, proto):
    """Deterministic plaintext problem from --seed (shared by sweep and
    finalize, so both derive the same fingerprint and expectations)."""
    rng = np.random.default_rng(args.seed)
    hi = (1 << args.bitsize) - 1
    templates = rng.integers(1, hi + 1, (args.n_templates, args.nslots))
    # One near-match enrolled.  Clamp into the slot domain: templates draw
    # from [1, hi], so +1 on an hi-valued slot would otherwise overflow to
    # hi+1, which int_to_bits truncates to 0 -- making the encrypted circuit
    # (which sees 0, the sub_abs forced-sign quirk domain) disagree with the
    # plaintext expectation below.  Seed 0 at the committed shapes never hits
    # the clamp (max pre-clamp slot is 255 = hi), so fingerprints of existing
    # checkpoint dirs are unchanged.
    probe = np.minimum(templates[args.n_templates // 3] + 1, hi)
    clear_d = ((templates - probe) ** 2).sum(1)
    want = (clear_d > proto.bound_match).astype(int)
    return templates, probe, want


def count_bootstraps_per_template(proto):
    """Exact per-template gate-bootstrap count of Server.identify's circuit
    (function_f at this geometry), measured by running it once on plaintext
    with the counting backend -- no hand-carried SURVEY constant."""
    from peba1 import circuits as cc
    from peba1.backends import CountingBackend
    from peba1.utils.bits import int_to_bits

    be = CountingBackend()
    t = int_to_bits(np.full((1, proto.nslots), 2), proto.bitsize)
    p = int_to_bits(np.full((1, proto.nslots), 1), proto.bitsize)
    bound = int_to_bits(np.array([proto.bound_match]), 3 * proto.bitsize)
    cc.function_f(be, p, t, bound, proto.bitsize)
    return be.bootstraps


def steady_rates(chunk_seconds, chunk_templates, boots_per_template):
    """Rate summary from per-chunk timings.  `steady` is the median per-chunk
    rate (robust to the first chunk's compile time); `overall` divides total
    templates by total seconds across all timed chunks."""
    if not chunk_seconds:
        return {}
    rates = [chunk_templates[i] / s for i, s in chunk_seconds.items()]
    steady = float(np.median(rates))
    total_t = sum(chunk_templates[i] for i in chunk_seconds)
    total_s = sum(chunk_seconds.values())
    return {
        "templates_per_s_steady": round(steady, 5),
        "templates_per_s_overall": round(total_t / total_s, 5),
        "effective_bootstraps_per_s": round(steady * boots_per_template, 1),
        "bootstraps_per_template": boots_per_template,
        "timed_chunks": len(chunk_seconds),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="peba1_128_t2",
                    choices=sorted(PRESETS))
    ap.add_argument("--n-templates", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--nslots", type=int, default=128)
    ap.add_argument("--bitsize", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dir", default="runs/sweep")
    ap.add_argument("--out", default=None)
    ap.add_argument("--max-chunks", type=int, default=0,
                    help="stop after computing this many NEW chunks this "
                         "process (0 = run to completion); used to stage a "
                         "deliberate interrupt + resume")
    ap.add_argument("--finalize", action="store_true",
                    help="verify + decrypt what is on disk and emit the "
                         "artifact; computes nothing on any device")
    ap.add_argument("--merge-rates", action="append", default=[],
                    help="prior partial artifact(s) whose chunk_seconds feed "
                         "the finalize rate summary (for chunks written "
                         "before per-chunk seconds lived in the chunk meta)")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    elif args.finalize:
        # Finalize is host-side verification; stay off the accelerator (a
        # sweep may be running on it).
        jax.config.update("jax_platforms", "cpu")

    log = stderr_log(bench="sweep_identify")
    proto = ProtocolParams(
        nslots=args.nslots, bitsize=args.bitsize,
        max_bitsize=3 * args.bitsize, mul_width=3 * args.bitsize - 1,
        bound_match=args.nslots * 2)
    tfhe = PRESETS[args.params]
    templates, probe, want = make_inputs(args, proto)

    kg, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(args.seed), 4)

    if args.finalize:
        with log.timer("secret_keygen"):
            sk = keys.secret_keygen(kg, tfhe)
        client = ClientDevice(7, sk, None, proto)
        finalize(args, proto, client, templates, want, k2, k3, log)
        return

    with log.timer("keygen"):
        sk, ck = jax.jit(keys.keygen, static_argnames=("params",))(
            kg, params=tfhe)
        np.asarray(ck.ks_table_limbs[0, :4])
    client = ClientDevice(7, sk, ck, proto)
    server = Server(ck, proto)

    # The template database is encrypted PER CHUNK inside the loop (chunk i
    # under jax.random.fold_in(k1, i), deterministic across staged runs):
    # encrypting 1024 full-width templates in one shot peaks >10 GB of
    # transient mask/limb buffers next to the resident keys and OOMs HBM
    # (observed, runs/sweep_r04_a.log).
    with log.timer("encrypt"):
        p_ct = client.encrypt_vector(k2, probe)
        bound_ct = client.encrypt_word(k3, proto.bound_match, 3 * args.bitsize)
        np.asarray(p_ct.b[..., :1])

    sw = sweep.IdentifySweep(server, args.dir, chunk=args.chunk, log=log)
    # database_id: deterministic from the generator config -- avoids the
    # 40 MB host pull and makes the fingerprint stable across processes.
    db_id = f"seed{args.seed}-n{args.n_templates}-s{args.nslots}b{args.bitsize}"
    # Bind the manifest up front with the ENGINE's fingerprint recipe so the
    # per-chunk writes below carry the same identity run()/collect() verify.
    plan = sweep.SweepPlan(
        n_templates=args.n_templates, chunk=args.chunk,
        fingerprint=sweep._fingerprint(p_ct, bound_ct, args.n_templates,
                                       args.chunk, db_id))
    prev = sw._load_manifest()
    import dataclasses as _dc
    if prev is not None and prev != _dc.asdict(plan):
        raise SystemExit(f"checkpoint dir {args.dir} holds a different sweep; "
                         "use a fresh --dir")
    sw._write_manifest(plan)

    chunk_times: "dict[str, float]" = {}
    state = {"computed_this_run": 0, "resumed": 0}
    t_start = time.time()

    def record(status):
        done = sw.completed_chunks()
        n_chunks = -(-args.n_templates // args.chunk)
        rec = {
            "metric": "identify_sweep_checkpointed",
            "status": status,
            "params": args.params,
            "n_templates": args.n_templates,
            "nslots": args.nslots, "bitsize": args.bitsize,
            "chunk": args.chunk,
            "chunks_done": len(done), "chunks_total": n_chunks,
            "templates_done": min(len(done) * args.chunk, args.n_templates),
            "computed_this_run": state["computed_this_run"],
            "resumed_from_disk": state["resumed"],
            "chunk_seconds": chunk_times,
            "seconds_this_run": round(time.time() - t_start, 1),
            "device": str(jax.devices()[0]),
            "checkpoint_dir": args.dir,
        }
        if args.out:
            atomic_json(args.out, rec)
        return rec

    # Chunk loop: IdentifySweep.run does all chunks in one call; for staged
    # interrupts and per-chunk artifact updates we drive chunk-by-chunk via
    # max-chunk-limited passes (each run() call skips finished chunks by
    # fingerprint -- that skip IS the resume bookkeeping being exercised).
    n_chunks = -(-args.n_templates // args.chunk)
    pre_done = set(sw.completed_chunks())
    state["resumed"] = len(pre_done)
    print(f"[sweep] {n_chunks} chunks of {args.chunk}; "
          f"{len(pre_done)} already on disk (resume)", flush=True)
    for i in range(n_chunks):
        if i in pre_done:
            continue
        lo = i * args.chunk
        hi_t = min(lo + args.chunk, args.n_templates)
        t0 = time.time()
        t_ct = client.encrypt_vector(jax.random.fold_in(k1, i),
                                     templates[lo:hi_t])
        out = server.identify(p_ct, t_ct, bound_ct)
        np.asarray(out.b[..., :1])  # host fetch = real barrier
        dt = time.time() - t0
        sweep._atomic_save(
            sweep._chunk_path(args.dir, i), out,
            {"chunk": i, "lo": lo, "hi": hi_t,
             "fingerprint": plan.fingerprint, "seconds": round(dt, 1)})
        chunk_times[str(i)] = round(dt, 1)
        state["computed_this_run"] += 1
        rate = (hi_t - lo) / dt
        print(f"[sweep] chunk {i + 1}/{n_chunks}: {dt:.0f}s "
              f"({rate:.4f} templates/s)", flush=True)
        record("running")
        if args.max_chunks and state["computed_this_run"] >= args.max_chunks:
            print(f"[sweep] stopping after {args.max_chunks} chunks "
                  "(staged interrupt); re-run to resume", flush=True)
            record("interrupted")
            return

    # Final integrity pass: collect() re-verifies EVERY chunk's fingerprint
    # against the manifest before reassembly (a stale or foreign chunk
    # raises), then the decisions are decrypted and checked end to end.
    collected = sw.collect()
    got = client.decrypt_word(collected)
    correct = float((np.asarray(got) == want).mean())
    rec = record("complete")
    rec["decisions_verified"] = int(np.asarray(got).shape[0])
    rec["correct_frac"] = correct
    # Per-chunk template counts for the rate summary (the last chunk may be
    # partial when n_templates is not a multiple of chunk).
    sizes = {i: (min((int(i) + 1) * args.chunk, args.n_templates)
                 - int(i) * args.chunk) for i in chunk_times}
    rec.update(steady_rates({i: v for i, v in chunk_times.items()}, sizes,
                            count_bootstraps_per_template(proto)))
    if args.out:
        atomic_json(args.out, rec)
    print(json.dumps(rec))


def finalize(args, proto, client, templates, want, k2, k3, log):
    """Verify + decrypt the on-disk state of a (possibly partial) sweep and
    emit the full evidence artifact.  Touches no accelerator."""
    from peba1.io import serial

    # Recompute the sweep fingerprint exactly as the compute path does: the
    # probe/bound ciphertexts are deterministic from --seed + secret key.
    # CAVEAT (measured): encryption noise (torus.gaussian_torus32) rounds
    # float->int32 differently across backends by +-1 ULP on some draws, so
    # a fingerprint computed on CPU only byte-matches a GPU-written manifest
    # if the draws happen to agree.  Exact match is recorded when it holds;
    # otherwise the binding proof is the decryption pass below -- every
    # checkpointed decision decrypting correctly under the seed-derived
    # secret key against the seed-derived plaintext distances is a far
    # stronger statement that these chunks belong to THIS sweep.
    p_ct = client.encrypt_vector(k2, np.minimum(
        templates[args.n_templates // 3] + 1, (1 << args.bitsize) - 1))
    bound_ct = client.encrypt_word(k3, proto.bound_match, 3 * args.bitsize)
    db_id = f"seed{args.seed}-n{args.n_templates}-s{args.nslots}b{args.bitsize}"
    fp_local = sweep._fingerprint(p_ct, bound_ct, args.n_templates, args.chunk,
                                  db_id)

    manifest_path = os.path.join(args.dir, sweep.MANIFEST)
    with open(manifest_path) as f:
        manifest = json.load(f)
    plan = sweep.SweepPlan(**manifest)
    fp = plan.fingerprint  # chunk integrity is checked against the manifest
    fp_exact = fp_local == fp
    if not fp_exact:
        print(f"[finalize] recomputed fingerprint {fp_local} != manifest "
              f"{fp} (cross-platform encryption-noise rounding); relying on "
              "the decryption pass for binding", flush=True)

    chunk_seconds: "dict[str, float]" = {}
    chunk_templates: "dict[str, int]" = {}
    for art in args.merge_rates:
        with open(art) as f:
            prior = json.load(f)
        for i, s in prior.get("chunk_seconds", {}).items():
            chunk_seconds[i] = float(s)

    n_verified = 0
    correct = 0
    chunks_present = []
    for i in range(plan.n_chunks):
        path = sweep._chunk_path(args.dir, i)
        if not os.path.exists(path):
            continue
        ct, meta = serial.load_ciphertext(path)
        if meta.get("fingerprint") != fp:
            raise SystemExit(f"chunk {i} fingerprint mismatch: "
                             f"{meta.get('fingerprint')} != {fp}")
        lo, hi_t = meta["lo"], meta["hi"]
        got = client.decrypt_word(ct)
        correct += int((np.asarray(got) == want[lo:hi_t]).sum())
        n_verified += hi_t - lo
        chunks_present.append(i)
        chunk_templates[str(i)] = hi_t - lo
        if "seconds" in meta:
            chunk_seconds[str(i)] = float(meta["seconds"])
        print(f"[finalize] chunk {i}: fingerprint ok, "
              f"{hi_t - lo} decisions decrypted", flush=True)

    complete = len(chunks_present) == plan.n_chunks
    # Only rate chunks whose size we know (merged artifacts may cover chunks
    # from other geometries only by index -- restrict to present chunks).
    timed = {i: s for i, s in chunk_seconds.items() if i in chunk_templates}
    rec = {
        "metric": "identify_sweep_checkpointed",
        "status": "complete" if complete else
                  f"partial ({len(chunks_present)}/{plan.n_chunks} chunks)",
        "finalize_mode": True,
        "params": args.params,
        "n_templates": args.n_templates,
        "nslots": args.nslots, "bitsize": args.bitsize,
        "chunk": args.chunk,
        "chunks_done": len(chunks_present),
        "chunks_total": plan.n_chunks,
        "templates_done": n_verified,
        "decisions_verified": n_verified,
        "correct_frac": (correct / n_verified) if n_verified else None,
        "fingerprint": fp,
        "fingerprint_match": "exact" if fp_exact else (
            "platform-divergent (noise-draw rounding differs across "
            "backends); binding established by the decryption pass"),
        "chunk_seconds": {i: chunk_seconds[i] for i in sorted(timed)},
        "checkpoint_dir": args.dir,
    }
    rec.update(steady_rates(timed, chunk_templates,
                            count_bootstraps_per_template(proto)))
    if args.out:
        atomic_json(args.out, rec)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
