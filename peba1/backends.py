"""Gate-execution backends for the circuit layer.

Circuits (circuits.py) are written against a tiny backend interface so the
same levelized schedule runs either:

  * CipherBackend -- real bootstrapped gates (gates.py); same-level
    heterogeneous gates are fused into ONE batched bootstrap launch via
    `lincomb_bootstrap` (the scheduler abstraction of SURVEY.md section 7,
    hard part #3);
  * ClearBackend -- plaintext 0/1 bit arrays; used property-test style to
    validate circuit structure/widths against the uint64 mirror (clear.py)
    quickly and exhaustively, mirroring the reference's oracle strategy
    (SURVEY.md section 4).

Values are backend-opaque "bit tensors": Lwe pytrees for cipher, int32
arrays for clear; both support numpy-style indexing on the trailing axes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import gates, lwe
from .keys import CloudKey

# gate name -> (wa, wb, offset) for the lincomb bootstrap (cipher),
# and the boolean function (clear).
_GATE_LIN = {
    "AND": (1, 1, -gates.MU_1_8),
    "OR": (1, 1, gates.MU_1_8),
    "NAND": (-1, -1, gates.MU_1_8),
    "NOR": (-1, -1, -gates.MU_1_8),
    "XOR": (2, 2, gates.MU_1_4),
    "XNOR": (-2, -2, -gates.MU_1_4),
    "ANDNY": (-1, 1, -gates.MU_1_8),
    "ANDYN": (1, -1, -gates.MU_1_8),
    "ORNY": (-1, 1, gates.MU_1_8),
    "ORYN": (1, -1, gates.MU_1_8),
}

_GATE_FN = {
    "AND": lambda a, b: a & b,
    "OR": lambda a, b: a | b,
    "NAND": lambda a, b: 1 - (a & b),
    "NOR": lambda a, b: 1 - (a | b),
    "XOR": lambda a, b: a ^ b,
    "XNOR": lambda a, b: 1 - (a ^ b),
    "ANDNY": lambda a, b: (1 - a) & b,
    "ANDYN": lambda a, b: a & (1 - b),
    "ORNY": lambda a, b: (1 - a) | b,
    "ORYN": lambda a, b: a | (1 - b),
}


@functools.partial(jax.jit, static_argnames=("shape", "bucket"))
def _level_flat(As, Bs, was, wbs, offs, shape: tuple, bucket: int) -> lwe.Lwe:
    """Stack L same-level gates, apply per-gate lincombs, flatten and pad --
    one dispatch.  As/Bs: tuples of Lwe; was/wbs/offs: (L,) int32."""
    dim = As[0].dim
    bc = lambda x: lwe.Lwe(jnp.broadcast_to(x.a, shape + (dim,)),
                           jnp.broadcast_to(x.b, shape))
    A = lwe.stack([bc(a) for a in As])
    B = lwe.stack([bc(b) for b in Bs])
    wshape = (len(As),) + (1,) * len(shape)
    wa = was.reshape(wshape)
    wb = wbs.reshape(wshape)
    off = offs.reshape(wshape)
    pre = lwe.Lwe(A.a * wa[..., None] + B.a * wb[..., None],
                  A.b * wa + B.b * wb + off)
    flat = lwe.Lwe(pre.a.reshape(-1, dim), pre.b.reshape(-1))
    return gates._pad_flat(flat, bucket)


@functools.partial(jax.jit, static_argnames=("L", "shape"))
def _level_post(out: lwe.Lwe, L: int, shape: tuple):
    """Slice the padded flat bootstrap output back into L per-gate results."""
    n = L * int(np.prod(shape, dtype=np.int64))
    res = lwe.Lwe(out.a[:n].reshape((L,) + shape + (out.dim,)),
                  out.b[:n].reshape((L,) + shape))
    return tuple(res[i] for i in range(L))


class CipherBackend:
    """Executes gates homomorphically under a cloud key."""

    is_cipher = True

    def __init__(self, ck: CloudKey):
        self.ck = ck
        self.launches = 0  # bootstrap launch counter (for tests/profiling)

    # -- single (batched) gates ------------------------------------------
    def gate(self, name: str, a, b):
        wa, wb, off = _GATE_LIN[name]
        self.launches += 1
        return gates.lincomb_bootstrap(self.ck, a, b, wa, wb, off)

    def __getattr__(self, name):
        if name in _GATE_LIN:
            return lambda a, b: self.gate(name, a, b)
        raise AttributeError(name)

    def NOT(self, a):
        return -a

    def MUX(self, a, b, c):
        self.launches += 1
        return gates.MUX(self.ck, a, b, c)

    def CONSTANT(self, value, shape=()):
        return gates.CONSTANT(self.ck, value, shape)

    # -- fused heterogeneous same-level gate batch -----------------------
    def level(self, ops):
        """ops: list of (name, a, b) at the same circuit depth -> list of results.

        All gates execute as ONE bootstrap launch: inputs are stacked along a
        new leading axis, per-gate (wa, wb, offset) broadcast elementwise.
        The stack + linear-combination + pad runs as ONE jitted dispatch and
        the post-slice as another (see gates._pre_flat on why: each eager op
        between launches is its own device dispatch).
        """
        shape = tuple(jnp.broadcast_shapes(
            *[x.shape for _, a, b in ops for x in (a, b)]))
        L = len(ops)
        w = np.array([_GATE_LIN[name] for name, _, _ in ops], np.int64)
        n = L * int(np.prod(shape, dtype=np.int64))
        self.launches += 1
        flat = _level_flat(
            tuple(a for _, a, _ in ops), tuple(b for _, _, b in ops),
            jnp.asarray(w[:, 0], jnp.int32), jnp.asarray(w[:, 1], jnp.int32),
            jnp.asarray(w[:, 2], jnp.int32),
            shape=shape, bucket=gates._bucket(n))
        out = gates._jit_bootstrap(self.ck, flat, jnp.int32(gates.MU_1_8))
        return list(_level_post(out, L=L, shape=shape))

    # -- structural helpers ----------------------------------------------
    def stack(self, xs, axis=0):
        return lwe.stack(xs, axis=axis)

    def concat(self, xs, axis=0):
        return lwe.concatenate(xs, axis=axis)


def _nelems(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


class ClearBackend:
    """Executes the same circuits on plaintext bit arrays (int32 0/1)."""

    is_cipher = False

    def __init__(self):
        self.launches = 0

    def gate(self, name: str, a, b):
        return jnp.asarray(_GATE_FN[name](jnp.asarray(a), jnp.asarray(b)), jnp.int32)

    def __getattr__(self, name):
        if name in _GATE_FN:
            return lambda a, b: self.gate(name, a, b)
        raise AttributeError(name)

    def NOT(self, a):
        return 1 - jnp.asarray(a)

    def MUX(self, a, b, c):
        return jnp.where(jnp.asarray(a) != 0, jnp.asarray(b), jnp.asarray(c))

    def CONSTANT(self, value, shape=()):
        return jnp.broadcast_to(jnp.asarray(value, jnp.int32), shape)

    def level(self, ops):
        return [self.gate(name, a, b) for name, a, b in ops]

    def stack(self, xs, axis=0):
        return jnp.stack([jnp.asarray(x) for x in xs], axis=axis)

    def concat(self, xs, axis=0):
        return jnp.concatenate([jnp.asarray(x) for x in xs], axis=axis)


class CountingBackend(ClearBackend):
    """ClearBackend that additionally counts the gate bootstraps the
    CipherBackend would execute for the same circuit run.

    Mechanical replacement for SURVEY.md section 3.6's static gate-count
    model (derived there by hand from /root/reference/src/Math.cpp): running
    a circuit once on plaintext at the target shape yields the exact
    per-item bootstrap count, from which protocol benchmarks derive
    "effective bootstraps/s" without any hand-carried constant.  Counting
    mirrors CipherBackend's batching: a lincomb gate is ONE bootstrap per
    broadcast element, MUX is TWO (gates.MUX), a fused level is
    len(ops) * broadcast-elements (backends._level_flat stacks every gate of
    the level to the common shape; padding is excluded -- it is launch
    overhead, not gate work).
    """

    def __init__(self):
        super().__init__()
        self.bootstraps = 0

    def gate(self, name, a, b):
        shape = jnp.broadcast_shapes(jnp.asarray(a).shape, jnp.asarray(b).shape)
        self.bootstraps += _nelems(shape)
        return super().gate(name, a, b)

    def MUX(self, a, b, c):
        shape = jnp.broadcast_shapes(*(jnp.asarray(x).shape for x in (a, b, c)))
        self.bootstraps += 2 * _nelems(shape)
        return super().MUX(a, b, c)

    def level(self, ops):
        shape = jnp.broadcast_shapes(
            *[jnp.asarray(x).shape for _, a, b in ops for x in (a, b)])
        self.bootstraps += len(ops) * _nelems(shape)
        # Execute via the BASE gate method: routing through self.gate would
        # double-count the level's gates.
        return [ClearBackend.gate(self, name, a, b) for name, a, b in ops]
