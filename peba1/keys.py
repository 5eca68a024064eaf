"""Key generation: secret keyset and cloud keyset.

Replaces the reference's opaque ``new_random_gate_bootstrapping_secret_keyset``
(/root/reference/src/main.cpp:22) with deterministic, PRNG-keyed generation
(SURVEY.md section 4: keyed CSPRNG replaces time(NULL) seeding).  The cloud
keyset holds the bootstrapping and keyswitch keys in the forms the batched
bootstrap reads:

  * bk_tp: each TRGSW row limb-split to int8 and doubled ("generator" form),
    from which a blind-rotation step assembles its negacyclic-Toeplitz GEMM
    weights in the graph (ops/poly.toeplitz_weights);
  * bk_w: those weights for every step, precomputed at keygen -- only where
    the whole form fits WEIGHT_KEY_BUDGET (`precomputes_weights`);
  * ks_table_limbs: the keyswitch key flattened to a (kN*t, (n+1)*4) int8
    matrix so key switching is a single digit-valued int8 matmul.

The secret-key / cloud-key split is a hard API boundary: server-side ops take
only CloudKey (fixing the reference's smell of the secret key riding through
server-side objects, /root/reference/include/Client.h:13).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from . import tlwe, torus
from .ops import poly
from .params import TfheParams


def _pytree_dataclass(*data_fields: str):
    """Frozen dataclass registered as a pytree with `params` as static
    metadata, plus the `.replace(**changes)` the callers use."""
    def wrap(cls):
        cls = dataclasses.dataclass(frozen=True)(cls)
        cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
        return jax.tree_util.register_dataclass(
            cls, data_fields=list(data_fields), meta_fields=["params"])
    return wrap


@_pytree_dataclass("lwe_key", "tlwe_key")
class SecretKey:
    lwe_key: jax.Array    # (n,) int32 bits -- the "small" key
    tlwe_key: jax.Array   # (k, N) int32 bits -- the ring key
    params: TfheParams

    @property
    def extracted_key(self) -> jax.Array:
        """(k*N,) int32 -- LWE key of sample-extracted ciphertexts."""
        return self.tlwe_key.reshape(-1)


@_pytree_dataclass("bk_tp", "bk_w", "ks_table_limbs")
class CloudKey:
    bk_tp: jax.Array           # (n, (k+1)l, C, 2N) int8 Toeplitz generator
    bk_w: jax.Array | None     # (n, C*N, (k+1)l*N) int8 step weights, or None
    ks_table_limbs: jax.Array  # (kN*t, (n+1)*4) int8 digit-matmul table
    params: TfheParams


# Budget for the precomputed step weights bk_w.  On an H100 they measured
# 5-20% more chained bootstraps/s than building each step's weights in the
# graph at batches of 64-1,024 on the t2 (10.9 GB) and k=1 l=2 (18.5 GB)
# lattices, and tied at 8,192.  Larger forms (the l=3 k=1 set, ~32 GB; the
# N=2048 ring, ~137 GB) would crowd out the protocol's working set or not
# fit, so those lattices build the weights in the graph.
WEIGHT_KEY_BUDGET = 20 * 2**30


def precomputes_weights(p: TfheParams) -> bool:
    """Whether keygen (and key loading) build bk_w for this lattice."""
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    return p.n * G * C * p.N * p.N <= WEIGHT_KEY_BUDGET


def secret_keygen(key: jax.Array, params: TfheParams) -> SecretKey:
    """The secret-key half of `keygen`, bit-identical to it (same PRNG
    splits).  Lets offline verifiers (e.g. sweep --finalize) reconstruct the
    client's key to decrypt checkpointed decisions WITHOUT paying for the
    cloud-key precomputations."""
    k_lwe, k_tlwe, _, _ = jax.random.split(key, 4)
    lwe_key = jax.random.bernoulli(k_lwe, 0.5, (params.n,)).astype(jnp.int32)
    tlwe_key = jax.random.bernoulli(k_tlwe, 0.5, (params.k, params.N)).astype(jnp.int32)
    return SecretKey(lwe_key=lwe_key, tlwe_key=tlwe_key, params=params)


def keygen(key: jax.Array, params: TfheParams) -> "tuple[SecretKey, CloudKey]":
    """Generate a full secret/cloud keyset deterministically from a PRNG key."""
    _, _, k_bk, k_ks = jax.random.split(key, 4)
    sk = secret_keygen(key, params)
    ck = make_cloud_key(k_bk, k_ks, sk)
    return sk, ck


def make_cloud_key(k_bk: jax.Array, k_ks: jax.Array, sk: SecretKey) -> CloudKey:
    p = sk.params
    # --- Bootstrapping key: TRGSW encryptions of each small-key bit, kept
    # in the doubled limb-split generator form the GEMM weights come from.
    bk = tlwe.trgsw_encrypt(k_bk, sk.tlwe_key, sk.lwe_key, p)  # (n, (k+1)l, k+1, N)
    bk_tp = jax.vmap(lambda g: poly.prepare_toeplitz_rhs(g, p.limb_plan))(bk)
    bk_w = poly.prepare_w_full(bk_tp) if precomputes_weights(p) else None

    # --- Keyswitch key: ks[i][j] = LWE_s(K_i / base^(j+1)); the switched
    # sample accumulates digit-value * row (ops/bootstrap.keyswitch_digits).
    kn = p.k * p.N
    K = sk.extracted_key  # (kN,)
    shifts = jnp.array([32 - (j + 1) * p.ks_basebit for j in range(p.ks_t)], jnp.int32)
    # mu[i, j] = K_i << shift_j  (int32 wrap)
    mu = K[:, None] << shifts[None, :]
    ka, ke = jax.random.split(k_ks)
    a = torus.uniform_torus32(ka, (kn, p.ks_t, p.n))
    e = torus.gaussian_torus32(ke, p.lwe_stdev, (kn, p.ks_t))
    b = poly.dot_key_i32(a, sk.lwe_key) + mu + e
    table = jnp.concatenate([a, b[..., None]], axis=-1)  # (kN, t, n+1)
    tl = poly.split_limbs_i8(table, 4)  # (kN, t, n+1, 4)
    ks_table_limbs = tl.reshape(kn * p.ks_t, (p.n + 1) * 4)
    return CloudKey(bk_tp=bk_tp, bk_w=bk_w, ks_table_limbs=ks_table_limbs,
                    params=p)
