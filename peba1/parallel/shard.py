"""Sharded bootstrap / protocol execution over a ('dp', 'tp') mesh.

Design (SURVEY.md section 2.4 mapping table):
  * ciphertext batch shards over dp (jax.shard_map); every device holds a
    replica of the bootstrapping key and runs the full blind rotation on its
    shard -- gate bootstraps are embarrassingly parallel across the batch;
  * the keyswitch one-hot matmul tensor-parallelizes over tp: the KS table's
    output columns (the n+1 LWE coefficients x limbs) split across tp ranks,
    each computing a partial-width slice, joined with one all_gather;
  * 1:N identification (`sharded_identify` / `sharded_identify_argmin`,
    BASELINE.json configs 3/5) shards the template database over dp: each
    shard runs the full encrypted-distance + threshold circuit on its
    templates; the argmin variant plays a local bootstrapped tournament per
    shard, all_gathers the <=dp encrypted finalists, and finishes the
    tournament replicated.

On a host of four cards joined all to all (NVLink), one process drives every
device and each collective reaches every card at the same rate, so the mesh
axes follow the algorithm alone: dp for independent ciphertexts or
templates, tp for the columns of one GEMM.

Single-device equivalence is exact (integer arithmetic, no reduction-order
effects), which the virtual-mesh tests assert.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import lwe
from ..keys import CloudKey
from ..ops import bootstrap as bs
from ..ops import poly, rotate


def shard_keyswitch_table(ck: CloudKey, n_tp: int) -> jax.Array:
    """Reshape the KS table for tp column sharding: (M, C) -> (tp, M, C/tp)."""
    m, c = ck.ks_table_limbs.shape
    pad = (-c) % n_tp
    t = jnp.pad(ck.ks_table_limbs, ((0, 0), (0, pad)))
    return t.reshape(m, n_tp, (c + pad) // n_tp).transpose(1, 0, 2)


def sharded_bootstrap(mesh: Mesh, ck: CloudKey, ct: lwe.Lwe, mu) -> lwe.Lwe:
    """Batched gate bootstrap with batch sharded over dp, KS matmul over tp.

    ct: (B,) flat batch; B must divide evenly by mesh dp size.

    The cloud key enters the shard_map body as an explicit pytree OPERAND
    with replicated specs -- never as a closure capture, so placement of the
    key tensors is deliberate rather than riding on XLA constant handling.
    """
    p = ck.params
    n_tp = mesh.shape["tp"]
    ks_sharded = shard_keyswitch_table(ck, n_tp)
    # The tp-column-sharded table replaces ks_table_limbs inside the body.
    ck_slim = ck.replace(ks_table_limbs=None)

    def local_fn(ck_local, ct_a, ct_b, ks_cols):
        # ks_cols: (1, M, C/tp) local slice of the keyswitch table
        local = lwe.Lwe(ct_a, ct_b)
        bara = rotate.modswitch_2n(local.a, p.N)
        barb = rotate.modswitch_2n(local.b, p.N)
        acc = bs.blind_rotate(ck_local, bara, barb, mu)
        from .. import tlwe
        a_ext, b_ext = tlwe.sample_extract(acc)
        # tp-parallel keyswitch: one-hot matmul against the local column slice
        digits = bs.keyswitch_digits(p, a_ext)
        part = jnp.dot(digits, ks_cols[0], preferred_element_type=jnp.int32)
        cols = jax.lax.all_gather(part, "tp", axis=1, tiled=True)  # (B/dp, C)
        cols = cols[:, : (p.n + 1) * 4]
        acc32 = poly.recombine_limbs_i32(cols.reshape(-1, p.n + 1, 4), 4)
        out = lwe.Lwe(-acc32[:, : p.n], b_ext - acc32[:, p.n])
        return out.a, out.b

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P("dp"), P("dp"), P("tp")),
        out_specs=(P("dp"), P("dp")),
        check_vma=False,
    )
    a, b = fn(ck_slim, ct.a, ct.b, ks_sharded)
    return lwe.Lwe(a, b)


def sharded_bootstrap_ringtp(mesh: Mesh, ck: CloudKey, ct: lwe.Lwe,
                             mu, overlap_blocks: int = 1) -> lwe.Lwe:
    """Gate bootstrap with the RING DIMENSION tensor-parallel over tp.

    The external product -- where the FLOPs and the weight bytes are -- is
    partitioned over the output coefficient axis j of Z[X]/(X^N+1): tp rank r
    assembles only columns [r*N/tp, (r+1)*N/tp) of every per-step negacyclic-
    Toeplitz weight matrix from the small replicated generator (CloudKey
    .bk_tp; the O(n*N^2) materialized form is never built full-width on any
    device), GEMMs the shared digit matrix against its slice, recombines
    limbs locally, and the per-step delta is joined with one tiled
    all_gather.  The accumulator stays replicated inside each tp group (its
    rotation mixes all coefficients); digits are recomputed per rank (cheap
    VPU work).  Batch shards over dp as usual; the keyswitch matmul reuses
    the tp column split of `sharded_bootstrap`.

    Per-rank weight-assembly work, GEMM MACs, and W bytes all drop by the
    tp factor -- the scaling story for BASELINE config 4 (N=2048, whose
    precomputed per-step weights would be O(n*G*N*C*N) ~ 137 GB; each rank
    assembles only its slice on the fly).

    Bit-identical to the single-device toeplitz path: every output
    coefficient is an independent integer dot, so partitioning the j axis
    changes no arithmetic (tests/test_parallel.py asserts equality on the
    virtual mesh).

    overlap_blocks (K > 1): chunked-column-gather overlap for the one
    collective that sits on the serial accumulator path.  Each rank's nj
    local columns split into K blocks; block b's (Bl, k+1, nj/K) partial
    delta is all_gathered as soon as its GEMM finishes, while the GEMM of
    block b+1 proceeds -- independent ops, so XLA's latency-hiding scheduler
    can hide (K-1)/K of the per-step gather bytes behind GEMM work.  Whether
    it pays on a four-card host has not been measured.  Bit-equality is
    unchanged (pure column reordering), asserted in CI for K=2.
    """
    from ..ops import decompose as dec

    p = ck.params
    n_tp = mesh.shape["tp"]
    if p.N % n_tp != 0:
        raise ValueError(f"N={p.N} not divisible by tp={n_tp}")
    nj = p.N // n_tp
    K = overlap_blocks
    if K < 1 or nj % K != 0:
        raise ValueError(f"overlap_blocks={K} must divide the per-rank "
                         f"column count N/tp={nj}")
    njb = nj // K
    ks_sharded = shard_keyswitch_table(ck, n_tp)
    B = ct.shape[0]
    dp = mesh.shape["dp"]
    Bl = B // dp

    def local_fn(ct_a, ct_b, bk_tp, ks_cols):
        j0 = jax.lax.axis_index("tp").astype(jnp.int32) * nj
        bara = rotate.modswitch_2n(ct_a, p.N)
        barb = rotate.modswitch_2n(ct_b, p.N)
        tv = jnp.full((Bl, p.N), jnp.int32(mu))
        acc = jnp.concatenate(
            [jnp.zeros((Bl, p.k, p.N), jnp.int32),
             rotate.negacyclic_rotate(
                 tv, (2 * p.N - barb) % (2 * p.N))[:, None, :]],
            axis=1)

        def step(acc, xs):
            amt, vv_i = xs
            rot = rotate.negacyclic_rotate(acc, amt[:, None])
            d = dec.decompose(rot - acc, p)           # (Bl, k+1, N, l)
            d = jnp.moveaxis(d, -1, -2).reshape(Bl, (p.k + 1) * p.l, p.N)
            if K == 1:
                cols = poly.extprod_toeplitz_cols_i8(
                    d, vv_i, p.limb_plan, j0, nj)     # (Bl, k+1, nj)
                delta = jax.lax.all_gather(cols, "tp", axis=-1, tiled=True)
            else:
                # Chunked gathers: fire each block's all_gather as soon as
                # its GEMM is done; the next block's GEMM is independent of
                # it, so the collective can ride behind GEMM work.
                gathered = []
                for b in range(K):
                    cols_b = poly.extprod_toeplitz_cols_i8(
                        d, vv_i, p.limb_plan, j0 + b * njb, njb)
                    gathered.append(jax.lax.all_gather(cols_b, "tp", axis=0))
                # gathered[b]: (tp, Bl, k+1, njb) holding global columns
                # r*nj + b*njb + c.  Reassemble coefficient order
                # (r, b, c) -> N.
                g = jnp.stack(gathered, axis=1)       # (tp, K, Bl, k+1, njb)
                delta = g.transpose(2, 3, 0, 1, 4).reshape(
                    Bl, p.k + 1, p.N)
            return acc + delta, ()

        acc, _ = jax.lax.scan(step, acc, (bara.T, bk_tp))
        from .. import tlwe
        a_ext, b_ext = tlwe.sample_extract(acc)
        digits = bs.keyswitch_digits(p, a_ext)
        part = jnp.dot(digits, ks_cols[0], preferred_element_type=jnp.int32)
        colsk = jax.lax.all_gather(part, "tp", axis=1, tiled=True)
        colsk = colsk[:, : (p.n + 1) * 4]
        acc32 = poly.recombine_limbs_i32(colsk.reshape(-1, p.n + 1, 4), 4)
        return -acc32[:, : p.n], b_ext - acc32[:, p.n]

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P(), P("tp")),
        out_specs=(P("dp"), P("dp")),
        check_vma=False,
    )
    a, b = fn(ct.a, ct.b, ck.bk_tp, ks_sharded)
    return lwe.Lwe(a, b)


def _tree_sum_local_then_global(be, words: lwe.Lwe, width: int) -> lwe.Lwe:
    """Local log-depth bootstrapped adder tree over this shard's slots, then
    one tiled all_gather of the tp partial words and a replicated finish.  Runs INSIDE a shard_map body with the slot axis (-2) sharded
    over 'tp'.  For power-of-two slots-per-shard and tp the overall addition
    tree is IDENTICAL to the single-device circuits.tree_sum, so outputs are
    bit-equal (mod-2^W associativity is not even needed)."""
    from .. import circuits as cc

    part = cc.tree_sum(be, words, width)              # word (..., W)
    # Gather the tp partial words into a new slot-like axis just before the
    # bit axis: word (..., tp, W).
    ga = jax.lax.all_gather(part.a, "tp", axis=part.a.ndim - 2)
    gb = jax.lax.all_gather(part.b, "tp", axis=part.b.ndim - 1)
    return cc.tree_sum(be, lwe.Lwe(ga, gb), width)


def _check_tp_slots(nslots: int, n_tp: int, op: str) -> None:
    if nslots % n_tp != 0:
        raise ValueError(f"{op}: nslots={nslots} not divisible by tp={n_tp}")
    local_slots = nslots // n_tp
    if local_slots & (local_slots - 1) or n_tp & (n_tp - 1):
        raise ValueError(
            f"{op} needs power-of-two slots per shard and tp "
            f"(got {local_slots} x {n_tp}) for tree-equality with tree_sum")


def sharded_tree_sum(mesh: Mesh, ck: CloudKey, words_ct: lwe.Lwe,
                     width: int) -> lwe.Lwe:
    """Encrypted slot-sum reduction partitioned over the mesh's tp axis.

    SURVEY.md section 2.4's "reduction parallelism" row: the reference's
    serial slot accumulation (/root/reference/src/Math.cpp:315-321,351-361)
    becomes a per-rank log-depth bootstrapped adder tree over nslots/tp
    slots, an all_gather of the tp partial-sum words (a few encrypted bits
    each), and a replicated finish -- the distance-sum bootstraps
    divide by tp.  Bit-equal to single-device circuits.tree_sum for
    power-of-two shard sizes (identical addition tree).

    words_ct: (..., nslots, W) bit-words, slot axis sharded over tp, leading
    axes over dp.  Returns (..., W), dp-sharded, replicated over tp.
    """
    from ..backends import CipherBackend

    _check_tp_slots(words_ct.shape[-2], mesh.shape["tp"], "sharded_tree_sum")
    lead = len(words_ct.shape) - 2  # leading batch axes ahead of (slots, W)
    spec_in = P(*(("dp",) + (None,) * (lead - 1) + ("tp",))) if lead \
        else P("tp")
    spec_out = P("dp") if lead else P()

    def local_fn(ck_, w_a, w_b):
        be = CipherBackend(ck_)
        out = _tree_sum_local_then_global(be, lwe.Lwe(w_a, w_b), width)
        return out.a, out.b

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), spec_in, spec_in),
        out_specs=(spec_out, spec_out),
        check_vma=False,
    )
    a, b = fn(ck, words_ct.a, words_ct.b)
    return lwe.Lwe(a, b)


def sharded_euclidean(mesh: Mesh, ck: CloudKey, probe_ct: lwe.Lwe,
                      templates_ct: lwe.Lwe, bitsize: int,
                      max_bitsize: int) -> lwe.Lwe:
    """Encrypted squared-Euclidean distance with the SLOT REDUCTION
    partitioned over the mesh's tp axis (batch over dp as usual).

    Per (dp, tp) cell: |b_i - a_i| + squaring on its nslots/tp slots, then
    the `sharded_tree_sum` mechanism (local tree + gathered finish).
    Bit-equal to circuits.euclidean for power-of-two shard sizes.

    probe_ct: (nslots, bitsize) bit-word, slot axis sharded over tp;
    templates_ct: (M, nslots, bitsize), M over dp.  Returns
    (M, max_bitsize), dp-sharded.
    """
    from .. import circuits as cc
    from ..backends import CipherBackend

    _check_tp_slots(templates_ct.shape[-2], mesh.shape["tp"],
                    "sharded_euclidean")

    def local_fn(ck_, t_a, t_b, p_a, p_b):
        be = CipherBackend(ck_)
        m = t_a.shape[0]
        probe_b = lwe.Lwe(jnp.broadcast_to(p_a, (m,) + p_a.shape),
                          jnp.broadcast_to(p_b, (m,) + p_b.shape))
        b = lwe.Lwe(t_a, t_b)
        diffs = cc.sub_abs(be, b, probe_b, bitsize)   # local slots only
        sq = cc.multiply(be, diffs[..., :bitsize], diffs[..., :bitsize],
                         bitsize, length=max_bitsize - 1)
        total = _tree_sum_local_then_global(be, sq, max_bitsize - 1)
        zero = be.CONSTANT(0, total[..., 0].shape + (1,))
        out = be.concat([total, zero], axis=-1)
        return out.a, out.b

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P("dp", "tp"), P("dp", "tp"), P("tp"), P("tp")),
        out_specs=(P("dp"), P("dp")),
        check_vma=False,
    )
    a, b = fn(ck, templates_ct.a, templates_ct.b,
              probe_ct.a, probe_ct.b)
    return lwe.Lwe(a, b)


def sharded_identify(mesh: Mesh, ck: CloudKey, probe_ct: lwe.Lwe,
                     templates_ct: lwe.Lwe, enc_bound: lwe.Lwe,
                     bitsize: int) -> lwe.Lwe:
    """1:N identification with the template database sharded over dp.

    templates_ct: (N, nslots, bitsize) encrypted database, probe/bound
    replicated.  Each dp rank runs the full Function_f circuit (encrypted
    Euclidean distance + threshold compare) on its N/dp templates -- every
    bootstrap launch on every device carries only local work; no cross-device
    traffic until the caller collects the (N, 3*bitsize) verdict words
    (returned dp-sharded on the leading axis).

    Exactly equal to protocol.Server.identify on one device (integer
    arithmetic, per-template independence).  BASELINE.json config 5's
    single-process form.
    """
    from .. import circuits as cc
    from ..backends import CipherBackend

    n_templates = templates_ct.shape[0]
    dp = mesh.shape["dp"]
    if n_templates % dp != 0:
        raise ValueError(f"n_templates={n_templates} not divisible by dp={dp}")

    def local_fn(ck_, t_a, t_b, p_a, p_b, bd_a, bd_b):
        be = CipherBackend(ck_)
        m = t_a.shape[0]
        probe_b = lwe.Lwe(jnp.broadcast_to(p_a, (m,) + p_a.shape),
                          jnp.broadcast_to(p_b, (m,) + p_b.shape))
        bound_b = lwe.Lwe(jnp.broadcast_to(bd_a, (m,) + bd_a.shape),
                          jnp.broadcast_to(bd_b, (m,) + bd_b.shape))
        out = cc.function_f(be, probe_b, lwe.Lwe(t_a, t_b), bound_b, bitsize)
        return out.a, out.b

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P("dp"), P("dp"), P(), P(), P(), P()),
        out_specs=(P("dp"), P("dp")),
        check_vma=False,
    )
    a, b = fn(ck, templates_ct.a, templates_ct.b,
              probe_ct.a, probe_ct.b, enc_bound.a, enc_bound.b)
    return lwe.Lwe(a, b)


def shard_lwe(mesh: Mesh, ct: lwe.Lwe, spec: P) -> lwe.Lwe:
    """Place an Lwe pytree on the mesh: `spec` applies to the batch dims (the
    body's shape); the mask's extra trailing dim stays unsharded."""
    a_spec = P(*(tuple(spec) + (None,)))
    return lwe.Lwe(
        jax.device_put(ct.a, NamedSharding(mesh, a_spec)),
        jax.device_put(ct.b, NamedSharding(mesh, spec)),
    )


def replicate_lwe(mesh: Mesh, ct: lwe.Lwe) -> lwe.Lwe:
    return lwe.Lwe(
        jax.device_put(ct.a, NamedSharding(mesh, P())),
        jax.device_put(ct.b, NamedSharding(mesh, P())),
    )


def gspmd_identify(mesh: Mesh, server, probe_ct: lwe.Lwe,
                   templates_ct: lwe.Lwe, enc_bound: lwe.Lwe) -> lwe.Lwe:
    """1:N identification via GSPMD sharding annotations: the template
    database is placed dp-sharded, probe/bound replicated, and the NORMAL
    per-level protocol circuit runs on the annotated arrays -- XLA partitions
    every bootstrap launch over the mesh (the gate math is batch-elementwise,
    so the per-level SPMD programs carry no collectives) and the results come
    back dp-sharded.

    This is the scaling-book recipe ("pick a mesh, annotate shardings, let
    XLA insert collectives") applied to the protocol, and the counterpart of
    `sharded_identify`: same math, per-level compiles (seconds each, shape-
    cached) instead of one whole-circuit program (minutes of XLA compile) --
    the form the virtual-CPU-mesh CI and the multichip dryrun can afford to
    run end-to-end.  Bit-equality with the single-device path is structural:
    the traced program per level is identical, only the layout differs.
    """
    t = shard_lwe(mesh, templates_ct, P("dp"))
    pr = replicate_lwe(mesh, probe_ct)
    bd = replicate_lwe(mesh, enc_bound)
    return server.identify(pr, t, bd)


def gspmd_identify_argmin(mesh: Mesh, server, probe_ct: lwe.Lwe,
                          templates_ct: lwe.Lwe):
    """Tournament argmin with GSPMD-annotated inputs (see gspmd_identify).
    The tournament's cross-shard rounds make XLA insert the collectives the
    hand-written version does explicitly."""
    t = shard_lwe(mesh, templates_ct, P("dp"))
    pr = replicate_lwe(mesh, probe_ct)
    return server.identify_argmin(pr, t)


def _argmin_local_then_global(be, vals: lwe.Lwe, idxs: lwe.Lwe):
    """Per-shard bootstrapped tournament + finalist all_gather + replicated
    finish.  Runs INSIDE a shard_map body over the 'dp' axis.  For
    power-of-two shard sizes the overall comparison tree is identical to the
    single-device argmin_tree over the global axis."""
    from .. import circuits as cc

    v, i = cc.argmin_tree(be, vals, idxs)
    ga = [jax.lax.all_gather(x, "dp", axis=0) for x in (v.a, v.b, i.a, i.b)]
    return cc.argmin_tree(be, lwe.Lwe(ga[0], ga[1]), lwe.Lwe(ga[2], ga[3]))


def sharded_argmin(mesh: Mesh, ck: CloudKey, vals_ct: lwe.Lwe,
                   idxs_ct: lwe.Lwe) -> "tuple[lwe.Lwe, lwe.Lwe]":
    """Encrypted tournament argmin over dp-sharded (M, W)/(M, I) word lists.

    The cross-shard mechanism of `sharded_identify_argmin`, exposed for
    pre-computed distance words (and for a cheap equality test: the full
    identify pipeline in one shard_map program is minutes of XLA compile on
    the virtual CPU mesh).  Returns replicated (min_val, min_idx).
    """
    from ..backends import CipherBackend

    def local_fn(ck_, v_a, v_b, i_a, i_b):
        be = CipherBackend(ck_)
        fv, fi = _argmin_local_then_global(
            be, lwe.Lwe(v_a, v_b), lwe.Lwe(i_a, i_b))
        return fv.a, fv.b, fi.a, fi.b

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P("dp"), P("dp"), P("dp"), P("dp")),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    va, vb, ia, ib = fn(ck, vals_ct.a, vals_ct.b,
                        idxs_ct.a, idxs_ct.b)
    return lwe.Lwe(va, vb), lwe.Lwe(ia, ib)


def sharded_identify_argmin(mesh: Mesh, ck: CloudKey, probe_ct: lwe.Lwe,
                            templates_ct: lwe.Lwe, bitsize: int,
                            max_bitsize: int) -> "tuple[lwe.Lwe, lwe.Lwe]":
    """Encrypted tournament argmin over a dp-sharded template database.

    Per dp rank: batched encrypted Euclidean distances for the local N/dp
    templates + a local log-depth bootstrapped tournament (circuits
    .argmin_tree) carrying GLOBAL index words (pre-built host-side and
    dp-sharded alongside the templates).  Cross-shard: the dp encrypted
    finalists (one (max_bitsize,) distance word + one index word each, a few
    KB) are all_gathered and the last log2(dp) tournament rounds run
    replicated on every device.

    For N = dp * 2^t (power-of-two shards) the overall comparison tree is
    IDENTICAL to the single-device argmin_tree over N, so results -- including
    tie-breaks (lowest index wins) -- are bit-equal, which
    tests/test_parallel.py asserts on the virtual mesh.

    Returns (enc_min_dist (max_bitsize,), enc_idx (ibits,)), replicated.
    """
    from .. import circuits as cc
    from ..backends import CipherBackend

    n_templates = templates_ct.shape[0]
    dp = mesh.shape["dp"]
    if n_templates % dp != 0:
        raise ValueError(f"n_templates={n_templates} not divisible by dp={dp}")
    ibits = max(1, (n_templates - 1).bit_length())
    idx_words = cc.const_word(CipherBackend(ck), np.arange(n_templates),
                              ibits, (n_templates,))

    def local_fn(ck_, t_a, t_b, i_a, i_b, p_a, p_b):
        be = CipherBackend(ck_)
        m = t_a.shape[0]
        probe_b = lwe.Lwe(jnp.broadcast_to(p_a, (m,) + p_a.shape),
                          jnp.broadcast_to(p_b, (m,) + p_b.shape))
        dists = cc.euclidean(be, probe_b, lwe.Lwe(t_a, t_b), bitsize,
                             max_bitsize)
        fv, fi = _argmin_local_then_global(be, dists, lwe.Lwe(i_a, i_b))
        return fv.a, fv.b, fi.a, fi.b

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P("dp"), P("dp"), P("dp"), P("dp"), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    va, vb, ia, ib = fn(ck, templates_ct.a, templates_ct.b,
                        idx_words.a, idx_words.b, probe_ct.a, probe_ct.b)
    return lwe.Lwe(va, vb), lwe.Lwe(ia, ib)
