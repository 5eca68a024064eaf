"""Self-contained lattice security estimate for the peba1 parameter sets.

Implements the standard core-SVP methodology (the "2016 estimate" of
Alkim-Ducas-Poppelmann-Schwabe, as used by NewHope/Kyber and by the
Albrecht-Player-Scott estimator's `bdd` primal model under the GSA):

  The uSVP primal attack embeds the LWE instance (secret dim n, modulus q,
  noise stdev sigma, using m samples) into a d = n + m + 1 lattice and runs
  BKZ-b.  All our secrets are uniform binary (stdev sigma_s = 1/2), so the
  Bai-Galbraith rescaling applies: secret coordinates are scaled by
  nu = sigma / sigma_s = 2*sigma, making the embedding lattice volume
  nu^n * q^m.  Under the geometric series assumption the attack succeeds
  when

      sigma * sqrt(b)  <=  delta(b)^(2b - d - 1) * (nu^n * q^m)^(1/d),
      delta(b) = ((pi*b)^(1/b) * b / (2*pi*e))^(1 / (2*(b - 1))).

  The attacker optimizes over m; the security level is taken as the
  core-SVP cost of the minimal working block size b_req:

      lambda_classical = 0.292 * b_req      [BDGL16 sieve]
      lambda_quantum   = 0.265 * b_req      [Laarhoven]

  Sanity anchor: core-SVP is deliberately a LOWER BOUND on attack cost (it
  prices the whole attack at one SVP call); full-cost models (BKZ tours,
  memory, polynomial factors) add ~15-25 bits.  This model yields ~98
  core-SVP classical bits for the TFHE v1.x n=630 / sigma=2^-15 instance,
  consistent with the published full-cost re-evaluations of exactly those
  parameters (~115-128 classical -- the original TFHE papers' "128").

Caveats: no memory costs and no dimensions-for-free correction (both would
RAISE the attack cost, so the estimate is attacker-favourable); GSA
inaccuracies only matter for tiny block sizes, far from this regime; the
dual/hybrid attacks are within a few bits of primal for these shapes.

The module-LWE argument for PEBA1_128_T2 does not depend on this script --
see SECURITY.md: the t2 instance is the SAME lattice as the k=1 instance.

Usage:  python scripts/security_estimate.py   # prints one JSON line per set
"""

from __future__ import annotations

import json
import math


def bkz_delta(b: int) -> float:
    return ((math.pi * b) ** (1.0 / b) * b / (2 * math.pi * math.e)) ** (
        1.0 / (2.0 * (b - 1)))


def primal_attack_succeeds(n: int, log2q: float, sigma: float, b: int,
                           m: int) -> bool:
    d = n + m + 1
    if b > d:
        return False
    lhs = math.log2(sigma) + 0.5 * math.log2(b)
    # Bai-Galbraith rescaled embedding for binary secrets (sigma_s = 1/2):
    # volume nu^n * q^m with nu = 2*sigma.
    log2_nu = math.log2(2.0 * sigma)
    rhs = (2 * b - d - 1) * math.log2(bkz_delta(b)) \
        + (log2q * m + log2_nu * n) / d
    return lhs <= rhs


def required_blocksize(n: int, log2q: float, sigma: float) -> "tuple[int, int]":
    """Minimal BKZ block size b for which SOME sample count m makes the
    primal attack succeed, and the optimizing m."""
    for b in range(60, 4000):
        # the optimum m is near sqrt(n * log2q / log2(delta)) - n; scan a
        # generous bracket around it
        for m in range(max(60, n // 4), 3 * n):
            if primal_attack_succeeds(n, log2q, sigma, b, m):
                return b, m
    raise RuntimeError("no attack found below b=4000 (parameters enormous?)")


INSTANCES = [
    # (name, secret dim, log2 q, noise stdev as fraction of q, note)
    ("lwe_n630", 630, 32.0, 2.0 ** -15,
     "TFHE v1.x lambda<=128 LWE/keyswitch instance (PEBA1_128* small key)"),
    ("rlwe_k1_N1024", 1024, 32.0, 2.0 ** -25,
     "TFHE v1.x TRLWE instance, k=1 N=1024 (PEBA1_128 / _FAST ring key)"),
    ("mlwe_k2_N512", 1024, 32.0, 2.0 ** -25,
     "PEBA1_128_T2 module instance k=2 N=512: total dim k*N=1024, same "
     "modulus/noise -- the SAME lattice as rlwe_k1_N1024 for every known "
     "attack (see SECURITY.md)"),
    ("lwe_n1024_ring2048", 1024, 32.0, 2.0 ** -17,
     "RING_2048 small key (n=1024, 2^-17)"),
    ("rlwe_k1_N2048", 2048, 32.0, 2.0 ** -28,
     "RING_2048 TRLWE instance (N=2048, 2^-28)"),
]


def main() -> None:
    for name, n, log2q, rel_sigma, note in INSTANCES:
        sigma = rel_sigma * 2.0 ** log2q  # absolute stdev
        b, m = required_blocksize(n, log2q, sigma)
        rec = {
            "instance": name,
            "n": n,
            "log2_q": log2q,
            "sigma_rel": rel_sigma,
            "blocksize": b,
            "samples": m,
            "classical_bits": round(0.292 * b, 1),
            "quantum_bits": round(0.265 * b, 1),
            "note": note,
        }
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
