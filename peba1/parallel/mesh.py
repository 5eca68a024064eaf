"""Device-mesh construction for the sharded bootstrap pipeline.

The reference has zero parallelism (SURVEY.md section 2.4); this is the
first-class replacement: a ('dp', 'tp') mesh where

  * dp  -- data parallel over the ciphertext/gate batch (independent gate
           bootstraps; the 1:N template database also shards here),
  * tp  -- tensor parallel over the keyswitch-table / external-product
           output columns (the wide int8 matmuls), reduced with collectives.

One process drives every card of a host.  On four cards joined all to all
(NVLink) every pair of devices talks at the same rate, so the layout follows
the algorithm alone: dp for independent work, tp for the columns of one GEMM.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_dp: int | None = None, n_tp: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_dp is None:
        n_dp = n // n_tp
    assert n_dp * n_tp <= n, f"need {n_dp}x{n_tp} devices, have {n}"
    arr = np.asarray(devices[: n_dp * n_tp]).reshape(n_dp, n_tp)
    return Mesh(arr, axis_names=("dp", "tp"))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-process entry point: wires `jax.distributed.initialize`.

    Pass all three arguments (e.g. coordinator "localhost:<port>"); nothing
    in the environment supplies them.  Must run before any other JAX call.
    Idempotent: a second call in an already-initialized process is a no-op.
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:  # already initialized
        if "already initialized" not in str(e).lower():
            raise


def make_global_mesh(n_tp: int = 1) -> Mesh:
    """Process-aware ('dp', 'tp') mesh over ALL processes' devices.

    Call after `init_distributed()` in every process.  Devices are ordered
    process-major by jax.devices(), so reshaping (n_total/n_tp, n_tp) keeps
    each tp group (the per-step collectives) inside one process as long as
    n_tp divides the per-process device count; dp spans processes.
    """
    devices = jax.devices()
    per_proc = len(jax.local_devices())
    if n_tp > 1 and per_proc % n_tp != 0:
        raise ValueError(
            f"n_tp={n_tp} must divide local device count {per_proc} so tp "
            "collectives stay inside one process")
    return make_mesh(n_dp=len(devices) // n_tp, n_tp=n_tp, devices=devices)


def batch_spec() -> P:
    """Sharding for a batched LWE pytree: batch over dp, replicated otherwise."""
    return P("dp")


def replicated() -> P:
    return P()
