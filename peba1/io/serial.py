"""Key and ciphertext (de)serialization -- SURVEY.md E9.

The reference includes tfhe_io.h but never calls it (include/Math.h:5,
include/Client.h:5; zero IO call sites): keys and ciphertexts never leave
process memory.  A real client/server deployment needs a stable on-disk/wire
format, so we define one: npz archives of the uint32/int8 tensors plus a
params JSON sidecar (SURVEY.md section 5 checkpoint/resume row).

All arrays are converted through numpy.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np

from .. import lwe
from ..keys import CloudKey, SecretKey
from ..params import TfheParams

FORMAT_VERSION = 2


def _params_to_json(p: TfheParams) -> str:
    return json.dumps({"format_version": FORMAT_VERSION, **dataclasses.asdict(p)})


def _params_from_json(s: str) -> TfheParams:
    d = json.loads(s)
    d.pop("format_version", None)
    return TfheParams(**d)


def save_secret_key(path: str, sk: SecretKey) -> None:
    np.savez_compressed(
        path,
        __params__=np.frombuffer(_params_to_json(sk.params).encode(), np.uint8),
        lwe_key=np.asarray(sk.lwe_key),
        tlwe_key=np.asarray(sk.tlwe_key),
    )


def load_secret_key(path: str) -> SecretKey:
    z = np.load(path)
    params = _params_from_json(bytes(z["__params__"]).decode())
    return SecretKey(lwe_key=jnp.asarray(z["lwe_key"]),
                     tlwe_key=jnp.asarray(z["tlwe_key"]), params=params)


def save_cloud_key(path: str, ck: CloudKey) -> None:
    np.savez_compressed(
        path,
        __params__=np.frombuffer(_params_to_json(ck.params).encode(), np.uint8),
        bk_tp=np.asarray(ck.bk_tp),
        ks_table_limbs=np.asarray(ck.ks_table_limbs),
    )


def load_cloud_key(path: str) -> CloudKey:
    """The precomputed weights bk_w are derived from bk_tp, so they are
    rebuilt here (for the lattices keygen builds them for), not stored."""
    from .. import keys
    from ..ops import poly

    z = np.load(path)
    params = _params_from_json(bytes(z["__params__"]).decode())
    bk_tp = jnp.asarray(z["bk_tp"])
    bk_w = (jax.jit(poly.prepare_w_full)(bk_tp)
            if keys.precomputes_weights(params) else None)
    return CloudKey(bk_tp=bk_tp, bk_w=bk_w,
                    ks_table_limbs=jnp.asarray(z["ks_table_limbs"]), params=params)


def save_ciphertext(path: str, ct: lwe.Lwe, meta: dict | None = None) -> None:
    np.savez_compressed(
        path,
        __meta__=np.frombuffer(json.dumps(
            {"format_version": FORMAT_VERSION, **(meta or {})}).encode(), np.uint8),
        a=np.asarray(ct.a),
        b=np.asarray(ct.b),
    )


def load_ciphertext(path: str) -> "tuple[lwe.Lwe, dict]":
    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    return lwe.Lwe(jnp.asarray(z["a"]), jnp.asarray(z["b"])), meta


def load_ciphertext_meta(path: str) -> dict:
    """Read only the metadata record of a ciphertext archive (npz members are
    decompressed lazily, so this never touches the tensor payload)."""
    z = np.load(path)
    return json.loads(bytes(z["__meta__"]).decode())
