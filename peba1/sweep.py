"""Checkpoint/resume engine for long 1:N identification sweeps.

SURVEY.md section 5 (failure detection / checkpoint-resume rows): the
reference has no persistence at all -- a crash in its (hour-scale) protocol
run loses everything (/root/reference/src/main.cpp:513-586 runs in one
process with no IO).  A 1:N sweep over 10k enrolled templates
(BASELINE.json config 3) is ~2.2e9 gate bootstraps; at any realistic
throughput that is minutes-to-hours of device time, so the sweep must survive
preemption.

Design: the template database is split into fixed-size chunks; each chunk is
one batched `Server.identify` launch whose encrypted decision words are
written to `<dir>/chunk_<i>.npz` (io.serial format) together with a
`manifest.json` recording the sweep configuration and a content fingerprint
of the inputs.  `run()` skips chunks whose output file already exists and
matches the manifest, so re-running after a crash resumes exactly where it
stopped.  `collect()` reassembles the (N, 3*bitsize) decision tensor.

Writes are atomic (tmp file + rename) so a kill mid-write never leaves a
truncated chunk that resume would trust.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import jax
import numpy as np

from . import lwe
from .io import serial
from .utils.logging import NULL_LOG, EventLog

MANIFEST = "manifest.json"


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    n_templates: int
    chunk: int
    fingerprint: str
    # Manifest schema version.  1 = original fingerprint (probe/bound/geometry
    # only); 2 = template database bound into the fingerprint.  Bump whenever
    # the fingerprint recipe changes so resume can distinguish "different
    # sweep" from "same sweep, older fingerprint format".
    schema: int = 2

    @property
    def n_chunks(self) -> int:
        return -(-self.n_templates // self.chunk)

    def chunk_range(self, i: int) -> "tuple[int, int]":
        lo = i * self.chunk
        return lo, min(lo + self.chunk, self.n_templates)


def _fingerprint(probe_ct: lwe.Lwe, enc_bound: lwe.Lwe, n_templates: int,
                 chunk: int, database_id: str) -> str:
    """Content hash binding a checkpoint dir to one (probe, bound, db) sweep.

    Hashes the probe/bound ciphertexts (small: one probe, one bound), the
    sweep geometry, and a template-database identity string (either caller
    supplied or derived by `_database_id` from the template bodies), so
    resuming in the same directory with a *different* database of the same
    shape is detected instead of silently reusing stale chunks.
    """
    h = hashlib.sha256()
    for arr in (probe_ct.a, probe_ct.b, enc_bound.a, enc_bound.b):
        h.update(np.ascontiguousarray(np.asarray(arr)).tobytes())
    h.update(json.dumps({"n": n_templates, "chunk": chunk,
                         "db": database_id}).encode())
    return h.hexdigest()[:16]


def _database_id(templates_ct: lwe.Lwe) -> str:
    """Cheap content identity of the template database: hash of the LWE
    BODIES only (one (N, nslots, bitsize) int32 host pull -- ~40 MB at
    N=10k, a one-off per run; the (..., n)-sized masks stay on device)."""
    b = np.ascontiguousarray(np.asarray(templates_ct.b))
    return hashlib.sha256(b.tobytes()).hexdigest()[:16]


def _chunk_path(out_dir: str, i: int) -> str:
    return os.path.join(out_dir, f"chunk_{i:06d}.npz")


def _atomic_save(path: str, ct: lwe.Lwe, meta: dict) -> None:
    tmp = path + ".tmp.npz"
    serial.save_ciphertext(tmp, ct, meta)
    # np.savez appends .npz only when missing; tmp already ends with it.
    os.replace(tmp, path)


class IdentifySweep:
    """Chunked, checkpointed 1:N identification (one probe vs N templates).

    Args:
      server: protocol.Server (cloud key only).
      out_dir: checkpoint directory; created if missing.
      chunk: templates per launch.  Larger chunks = better device batching,
        smaller chunks = finer-grained resume.
      log: EventLog for structured progress events.
    """

    def __init__(self, server, out_dir: str, chunk: int = 256,
                 log: EventLog = NULL_LOG):
        self.server = server
        self.out_dir = out_dir
        self.chunk = chunk
        self.log = log
        os.makedirs(out_dir, exist_ok=True)

    # -- manifest ---------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.out_dir, MANIFEST)

    def _load_manifest(self) -> Optional[dict]:
        p = self._manifest_path()
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def _write_manifest(self, plan: SweepPlan) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(plan), f)
        os.replace(tmp, self._manifest_path())

    # -- main entry points --------------------------------------------------
    def run(self, probe_ct: lwe.Lwe, templates_ct: lwe.Lwe, enc_bound: lwe.Lwe,
            resume: bool = True, database_id: Optional[str] = None) -> SweepPlan:
        """Sweep all templates, checkpointing each chunk; returns the plan.

        templates_ct: (N, nslots, bitsize) encrypted template database.
        database_id: optional caller-supplied version string identifying the
        template database; when None, a content hash of the template bodies
        is used (one host pull).  Either way the database is bound into the
        checkpoint fingerprint.  On resume, chunks already on disk (matching
        manifest AND per-chunk fingerprint) are skipped without touching the
        device.
        """
        n_templates = templates_ct.shape[0]
        if database_id is None:
            database_id = _database_id(templates_ct)
        plan = SweepPlan(n_templates=n_templates, chunk=self.chunk,
                         fingerprint=_fingerprint(probe_ct, enc_bound,
                                                  n_templates, self.chunk,
                                                  database_id))
        prev = self._load_manifest()
        if prev is not None and prev != dataclasses.asdict(plan):
            if resume:
                if prev.get("schema", 1) != plan.schema:
                    raise ValueError(
                        f"checkpoint dir {self.out_dir} was written with "
                        f"manifest schema v{prev.get('schema', 1)} (this "
                        f"version uses v{plan.schema}: the fingerprint now "
                        "binds the template database).  The directory is not "
                        "corrupt, but its chunks cannot be verified against "
                        "the new fingerprint -- recompute in a fresh "
                        "directory or pass resume=False to overwrite")
                raise ValueError(
                    f"checkpoint dir {self.out_dir} holds a different sweep "
                    f"({prev} != {dataclasses.asdict(plan)}); pass resume=False "
                    "to overwrite or use a fresh directory")
            for i in range(prev.get("n_templates", 0) // max(prev.get("chunk", 1), 1) + 1):
                p = _chunk_path(self.out_dir, i)
                if os.path.exists(p):
                    os.remove(p)
        self._write_manifest(plan)

        done = skipped = 0
        for i in range(plan.n_chunks):
            path = _chunk_path(self.out_dir, i)
            if resume and os.path.exists(path):
                # Trust-but-verify: a stale/foreign chunk in a dir whose
                # manifest was lost must be recomputed now, not discovered
                # later in collect().
                try:
                    meta = serial.load_ciphertext_meta(path)
                except Exception:
                    meta = {}
                if meta.get("fingerprint") == plan.fingerprint:
                    skipped += 1
                    continue
                os.remove(path)
            lo, hi = plan.chunk_range(i)
            with self.log.timer("sweep_chunk", chunk=i, lo=lo, hi=hi):
                out = self.server.identify(
                    probe_ct, templates_ct[lo:hi], enc_bound)
                out = jax.block_until_ready(out)
                _atomic_save(path, out, {"chunk": i, "lo": lo, "hi": hi,
                                         "fingerprint": plan.fingerprint})
            done += 1
        self.log.log("sweep_done", n_chunks=plan.n_chunks, computed=done,
                     resumed_from=skipped)
        return plan

    def completed_chunks(self) -> "list[int]":
        m = self._load_manifest()
        if m is None:
            return []
        plan = SweepPlan(**m)
        return [i for i in range(plan.n_chunks)
                if os.path.exists(_chunk_path(self.out_dir, i))]

    def collect(self) -> lwe.Lwe:
        """Concatenate all chunk outputs into (N, 3*bitsize) decision words."""
        m = self._load_manifest()
        if m is None:
            raise FileNotFoundError(f"no manifest in {self.out_dir}")
        plan = SweepPlan(**m)
        parts_a, parts_b = [], []
        for i in range(plan.n_chunks):
            ct, meta = serial.load_ciphertext(_chunk_path(self.out_dir, i))
            if meta.get("fingerprint") != plan.fingerprint:
                raise ValueError(f"chunk {i} belongs to a different sweep")
            parts_a.append(np.asarray(ct.a))
            parts_b.append(np.asarray(ct.b))
        return lwe.Lwe(np.concatenate(parts_a), np.concatenate(parts_b))
