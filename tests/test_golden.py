"""Golden decision-level conformance corpus (SURVEY.md hard part #2).

Pins three things against the frozen tests/data/golden_corpus.json:
  1. the corpus GENERATOR (deterministic regeneration matches the file);
  2. the clear mirror's decisions (recomputed ed / f_clear polarity);
  3. the full-protocol-width (nslots=128, bitsize=8) gate schedule via the
     ClearBackend -- the exact circuit the cipher backend executes, at the
     exact reference widths, decision bits AND blinded nonces.

The cipher-side evaluation of the same corpus runs on the accelerator via
scripts/diag.py golden -- too slow for CPU CI at full width, but the
backend-equivalence of the gate schedule is pinned at small width by
tests/test_protocol.py.
"""

import os

import numpy as np

from peba1 import clear
from peba1 import conformance as cf
from peba1.backends import ClearBackend
from peba1.utils.bits import bits_to_int

CORPUS = os.path.join(os.path.dirname(__file__), "data", "golden_corpus.json")


def test_generator_matches_frozen_corpus():
    frozen = cf.load_corpus(CORPUS)
    regen = cf.make_corpus(frozen["n_cases"], frozen["nslots"],
                           frozen["bitsize"], frozen["seed"])
    assert regen == frozen


def test_clear_mirror_decisions():
    corpus = cf.load_corpus(CORPUS)
    t, p, bounds, r0, r1, want_b, want_y = cf.corpus_arrays(corpus)
    for i in range(len(bounds)):
        ed = int(clear.euclidean_distance(t[i], p[i]))
        assert ed == corpus["cases"][i]["ed"]
        f_clear = int(clear.function_f_clear(
            t[i].astype(np.uint64), p[i].astype(np.uint64), int(bounds[i]), 64))
        assert 1 - f_clear == want_b[i]
        # Clear mirror y is plain (1-b)*r0 + b*r1; the GATE-level y differs
        # for b == 0 (sub_abs(1, 0) quirk gives -r0 mod 2^bitsize, SURVEY.md
        # 3.2) -- the golden corpus records the gate-level value.
        y_mirror = int(clear.function_g_clear(np.uint64(want_b[i]),
                                              int(r0[i]), int(r1[i]), 64))
        if want_b[i]:
            assert y_mirror % (1 << corpus["bitsize"]) == want_y[i]
        else:
            assert y_mirror == int(r0[i])
            assert want_y[i] == (-int(r0[i])) % (1 << corpus["bitsize"])


def test_full_width_circuit_decisions():
    """function_f + function_g at nslots=128 / bitsize=8, all 64 cases as one
    batch, on the ClearBackend (the same levelized schedule the cipher
    backend runs)."""
    corpus = cf.load_corpus(CORPUS)
    _, _, _, _, _, want_b, want_y = cf.corpus_arrays(corpus)
    b_word, y_word = cf.eval_circuit(ClearBackend(), corpus)
    got_b = bits_to_int(np.asarray(b_word))
    got_y = bits_to_int(np.asarray(y_word))
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_y, want_y)
