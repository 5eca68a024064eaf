"""Golden decision-level conformance corpus (SURVEY.md hard part #2).

Freezes a deterministic set of (template, probe, bound, r0, r1) protocol
instances at FULL reference width (nslots=128, bitsize=8 -- the constants of
/root/reference/src/main.cpp:30-32) together with the expected gate-level
decisions:

  ed = squared Euclidean distance    (src/Math.cpp:333-369 semantics)
  b  = [ed > bound]                  (the Function_f gate output polarity,
                                      src/Math.cpp:379-387; NB the clear
                                      mirror Function_f_clear is inverted,
                                      SURVEY.md 3.2 discrepancy #1)
  y  = r1 if b == 1 else (-r0 mod 2^bitsize)
                                     (Function_g incl. the sub_abs(1, 0)
                                      quirk, src/Math.cpp:390-417)

The corpus is the conformance contract: tests/test_golden.py pins the
generator and the full-width ClearBackend circuit against the frozen JSON,
and scripts/diag.py (mode `golden`) evaluates the CIPHER circuit on the
corpus on the accelerator, producing a decision-equality record.

Case mix (4 kinds, cycling): the reference driver's own matching pair
(probe = template + 1, ED = nslots, bound = 2*nslots, src/main.cpp:39,520),
a random non-match, an exact ed == bound tie (b must be 0: compare_gt is 0
on equality), and an ed = bound + 1 near-tie (b must be 1).
"""

from __future__ import annotations

import json

import numpy as np

from . import clear

CORPUS_SEED = 20260820
NSLOTS = 128
BITSIZE = 8


def make_corpus(n_cases: int = 64, nslots: int = NSLOTS,
                bitsize: int = BITSIZE, seed: int = CORPUS_SEED) -> dict:
    """Deterministic corpus with expected gate-level decisions."""
    rng = np.random.default_rng(seed)
    hi = (1 << bitsize) - 1
    cases = []
    for i in range(n_cases):
        template = rng.integers(1, hi, nslots)
        kind = i % 4
        if kind == 0:
            probe = template + 1                      # ED = nslots
            bound = 2 * nslots                        # reference driver pair
        else:
            probe = rng.integers(1, hi + 1, nslots)
            ed_raw = int(clear.euclidean_distance(template, probe))
            if kind == 1:
                bound = 2 * nslots
            elif kind == 2:
                bound = ed_raw                        # tie: b must be 0
            else:
                bound = max(ed_raw - 1, 0)            # b must be 1 (ed >= 1)
        ed = int(clear.euclidean_distance(template, probe))
        assert ed < 1 << (3 * bitsize - 1), ed        # fits the 23-bit acc
        r0 = int(rng.integers(0, 1 << bitsize))
        r1 = int(rng.integers(0, 1 << bitsize))
        b = int(ed > bound)
        y = r1 if b else (-r0) % (1 << bitsize)
        # Cross-check against the (inverted) clear mirror.
        f_clear = int(clear.function_f_clear(
            template.astype(np.uint64), probe.astype(np.uint64), bound, 64))
        assert b == 1 - f_clear, (i, ed, bound)
        cases.append({
            "template": template.tolist(), "probe": probe.tolist(),
            "bound": int(bound), "r0": r0, "r1": r1,
            "ed": ed, "b": b, "y": int(y),
        })
    return {"seed": seed, "nslots": nslots, "bitsize": bitsize,
            "n_cases": n_cases, "cases": cases}


def save_corpus(path: str, corpus: dict) -> None:
    with open(path, "w") as f:
        json.dump(corpus, f, separators=(",", ":"))


def load_corpus(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def corpus_arrays(corpus: dict):
    """Stack the corpus into batched numpy arrays for circuit evaluation.

    Returns (templates (M, nslots), probes (M, nslots), bounds (M,),
    r0 (M,), r1 (M,), expected_b (M,), expected_y (M,)).
    """
    cs = corpus["cases"]
    t = np.array([c["template"] for c in cs])
    p = np.array([c["probe"] for c in cs])
    return (t, p, np.array([c["bound"] for c in cs]),
            np.array([c["r0"] for c in cs]), np.array([c["r1"] for c in cs]),
            np.array([c["b"] for c in cs]), np.array([c["y"] for c in cs]))


def eval_circuit(be, corpus: dict):
    """Run function_f + function_g on the whole corpus as ONE batch on any
    backend (ClearBackend for CI, CipherBackend on the accelerator).

    Returns (b_word, y_word) backend words of shape (M, 3*bitsize) / (M,
    bitsize); the decision bit is b_word[..., 0].
    """
    from . import circuits as cc
    from .utils.bits import int_to_bits

    bitsize = corpus["bitsize"]
    t, p, bounds, r0, r1, _, _ = corpus_arrays(corpus)
    if be.is_cipher:
        raise ValueError("cipher evaluation needs encrypted inputs; use "
                         "eval_cipher")
    import jax.numpy as jnp
    tb = jnp.asarray(int_to_bits(t, bitsize), jnp.int32)
    pb = jnp.asarray(int_to_bits(p, bitsize), jnp.int32)
    bb = jnp.asarray(int_to_bits(bounds, 3 * bitsize), jnp.int32)
    b_word = cc.function_f(be, pb, tb, bb, bitsize)
    r0b = jnp.asarray(int_to_bits(r0, bitsize), jnp.int32)
    r1b = jnp.asarray(int_to_bits(r1, bitsize), jnp.int32)
    y_word = cc.function_g(be, b_word, r0b, r1b, bitsize)
    return b_word, y_word


def eval_cipher(sk, ck, corpus: dict, key, batch: int | None = None):
    """Encrypt the corpus and run the cipher circuit; returns decrypted
    (b (M,), y (M,)) ints.  `batch` evaluates the corpus in chunks (memory
    control on the accelerator)."""
    import jax

    from . import circuits as cc
    from . import gates
    from .backends import CipherBackend
    from .utils.bits import bits_to_int, int_to_bits

    bitsize = corpus["bitsize"]
    t, p, bounds, r0, r1, _, _ = corpus_arrays(corpus)
    M = t.shape[0]
    step = batch or M
    bs_out, ys_out = [], []
    for lo in range(0, M, step):
        hi = min(lo + step, M)
        ks = jax.random.split(jax.random.fold_in(key, lo), 3)
        be = CipherBackend(ck)
        et = gates.encrypt_bits(ks[0], sk, int_to_bits(t[lo:hi], bitsize))
        ep = gates.encrypt_bits(ks[1], sk, int_to_bits(p[lo:hi], bitsize))
        eb = gates.encrypt_bits(ks[2], sk, int_to_bits(bounds[lo:hi], 3 * bitsize))
        b_word = cc.function_f(be, ep, et, eb, bitsize)
        r0w = cc.const_word(be, r0[lo:hi], bitsize, (hi - lo,))
        r1w = cc.const_word(be, r1[lo:hi], bitsize, (hi - lo,))
        y_word = cc.function_g(be, b_word, r0w, r1w, bitsize)
        bs_out.append(bits_to_int(np.asarray(gates.decrypt_bits(b_word, sk))))
        ys_out.append(bits_to_int(np.asarray(gates.decrypt_bits(y_word, sk))))
    return np.concatenate(bs_out), np.concatenate(ys_out)
