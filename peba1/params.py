"""TFHE parameter sets.

Reimplements the role of the reference's external parameter factory
``new_default_gate_bootstrapping_parameters(lambda)`` (called at
/root/reference/src/main.cpp:21) as frozen dataclasses.  The lambda=128 preset
mirrors the well-known TFHE v1.x defaults the reference binary runs with
(SURVEY.md section 2.2 E1): LWE n=630 / ks_stdev 2^-15, TRLWE N=1024 k=1 /
bk_stdev 2^-25, gadget l=3 Bg=2^7, keyswitch t=8 base 2^2.

All torus elements are represented as int32 ("torus32"): the real torus
R/Z scaled by 2^32, with native wrap-around arithmetic (SURVEY.md E2).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TfheParams:
    """Complete parameter set for the gate-bootstrapping TFHE scheme.

    Attributes:
      n: LWE (small) mask dimension.
      lwe_stdev: stdev (fraction of torus) of fresh LWE encryption noise under
        the small key (TFHE's ``ks_stdev``).
      N: TRLWE ring dimension; polynomials live in Z[X]/(X^N+1).
      k: TRLWE mask size (number of mask polynomials); TFHE default 1.
      tlwe_stdev: stdev of TRLWE/TRGSW encryption noise (TFHE's ``bk_stdev``).
      l: gadget decomposition length (digits per torus element).
      bgbit: log2 of the gadget base Bg.
      ks_t: keyswitch decomposition length.
      ks_basebit: log2 of the keyswitch decomposition base.
      max_stdev: maximum tolerable noise stdev for correct 1/4-msg-space
        decryption (used only by validation checks / noise tests).
      bk_limbs: number of balanced 8-bit limbs used for the MASK polynomials
        of the bootstrapping key in the int8 external-product GEMM.  Must stay
        4 (exact): rounding error in a mask polynomial is multiplied by the
        secret key polynomial when the phase is decrypted, amplifying its
        stdev by ~sqrt(N/2) (~x23 at N=1024), which breaks decoding.
      bk_body_limbs: limbs for the BODY polynomial columns.  Body rounding
        error enters the phase directly (no key amplification): dropping the
        low byte (3 limbs) adds stdev ~2^-10 of a torus over n=630 CMUX
        steps, far below max_stdev, and saves 1/((k+1)*4) of the MACs.

    Only lattice and gadget fields live here: there is one bootstrap path
    (ops/bootstrap.blind_rotate), so no field selects a kernel.
    """

    n: int
    lwe_stdev: float
    N: int
    k: int
    tlwe_stdev: float
    l: int
    bgbit: int
    ks_t: int
    ks_basebit: int
    max_stdev: float = 0.012467
    bk_limbs: int = 4
    bk_body_limbs: int = 4

    @property
    def bg(self) -> int:
        return 1 << self.bgbit

    @property
    def half_bg(self) -> int:
        return 1 << (self.bgbit - 1)

    @property
    def ks_base(self) -> int:
        return 1 << self.ks_basebit

    @property
    def limb_plan(self) -> "tuple[int, ...]":
        """Per-output-polynomial limb counts for the external product:
        k mask polys (exact) then the body poly (possibly truncated)."""
        return (self.bk_limbs,) * self.k + (self.bk_body_limbs,)

    @property
    def big_n(self) -> int:
        """Dimension of the extracted LWE ciphertext (= k*N)."""
        return self.k * self.N

    @property
    def log2_2N(self) -> int:
        return int(math.log2(2 * self.N))

    def __post_init__(self):
        assert self.N & (self.N - 1) == 0, "N must be a power of two"
        assert 1 <= self.bk_body_limbs <= self.bk_limbs <= 4
        assert self.bgbit * self.l <= 32
        assert self.ks_basebit * self.ks_t <= 32
        # int8 exactness bound for the external-product GEMM:
        # contraction of (k+1)*l*N terms of digit(<=2^(bgbit-1)) * limb(<=2^7)
        bound = (self.k + 1) * self.l * self.N * (1 << (self.bgbit - 1)) * 128
        assert bound < 2**31, "external-product int32 accumulation would overflow"


# TFHE v1.x gate-bootstrapping defaults for minimum_lambda <= 128, the set the
# reference binary uses (src/main.cpp:20-21 passes lambda=128).
PEBA1_128 = TfheParams(
    n=630,
    lwe_stdev=2.0**-15,
    N=1024,
    k=1,
    tlwe_stdev=2.0**-25,
    l=3,
    bgbit=7,
    ks_t=8,
    ks_basebit=2,
)

# Larger-ring set for BASELINE.json config 4 (N=2048, higher security margin).
# Digits are +-128 with bgbit=8, still int8-representable; the int32
# accumulation bound (k+1)*l*N*128*128 = 2^30.6 still holds.
RING_2048 = TfheParams(
    n=1024,
    lwe_stdev=2.0**-17,
    N=2048,
    k=1,
    tlwe_stdev=2.0**-28,
    l=2,
    bgbit=8,
    ks_t=8,
    ks_basebit=2,
)

# Tiny parameters for fast CPU tests.  Noise-free (stdev 0) so that every
# pipeline stage is exactly deterministic; modswitch rounding is the only
# "noise", and with n=32, N=128 its typical magnitude (~sqrt(n)/(4N*sqrt(3)))
# is far below the 1/16 decoding margin.
TOY = TfheParams(
    n=32,
    lwe_stdev=0.0,
    N=128,
    k=1,
    tlwe_stdev=0.0,
    l=3,
    bgbit=7,
    ks_t=8,
    ks_basebit=2,
)

# Toy set with realistic-shaped (but scaled) noise for noise-growth tests.
TOY_NOISY = TfheParams(
    n=32,
    lwe_stdev=2.0**-15,
    N=128,
    k=1,
    tlwe_stdev=2.0**-25,
    l=3,
    bgbit=7,
    ks_t=8,
    ks_basebit=2,
)

# Throughput-tuned variant of the lambda=128 set.  Two levers, same
# security (n, N, key distributions, encryption noise unchanged):
#   * l=2 / Bg=2^8 gadget: (k+1)*l = 4 digit rows instead of 6 (-33% GEMM
#     MACs).  Requires the round-to-nearest gadget offset
#     (ops/decompose.gadget_offset) -- with TFHE's biased truncation this
#     gadget mis-decodes ~5%/gate.
#   * body polynomial truncated to 3 limbs (-12.5% MACs): body rounding
#     error enters the phase directly (no key amplification), stdev ~2^-10;
#     the mask stays exact (its rounding error is key-convolved, x~sqrt(N/2),
#     and breaks decoding -- see TfheParams.bk_limbs).
# Its noise evidence is the chained-gate campaign record NOISE_<preset>.json
# (scripts/diag.py campaign), pinned by tests/test_noise.py.
PEBA1_128_FAST = dataclasses.replace(PEBA1_128, l=2, bgbit=8, bk_body_limbs=3)

# TOY with the PEBA1_128_FAST levers so that lattice runs end-to-end on CPU.
TOY_FAST = dataclasses.replace(TOY, l=2, bgbit=8, bk_body_limbs=3)

# Module-LWE throughput set: k=2 rank-2 module over N=512 instead of k=1 over
# N=1024.  Same total key dimension k*N = 1024, same key distribution
# (uniform binary) and same noise rates as PEBA1_128_FAST, so the MLWE
# instance is at least as hard as the k=1 RLWE instance of equal dimension
# (module structure interpolates from ring- toward plain LWE) -- lambda ~ 128
# like TFHE v1.x's N=1024 set.  Why it is cheaper: external-product MACs
# scale as (k+1)*l*N x (k*mask_limbs + body_limbs)*N = 3072 x 5632 per step,
# 0.59x of the k=1 set's 4096 x 7168, and the per-step barrel rotation
# touches (k+1)*N = 1536 int32 values over log2(2N) = 10 stages (0.68x).  The
# price is modswitch rounding to Z_{2N} with N=512 (a-priori per-coefficient
# stdev sqrt(n/12)/(2N) = 0.0070 vs 0.0035 at N=1024); the measured
# steady-state phase error is in its campaign record NOISE_peba1_128_t2.json.
PEBA1_128_T2 = dataclasses.replace(
    PEBA1_128, k=2, N=512, l=2, bgbit=8, bk_body_limbs=3)

# TOY-scale module set (k=2) so every MLWE code path runs on CPU.
TOY_T2 = dataclasses.replace(TOY, k=2, N=128, l=2, bgbit=8, bk_body_limbs=3)

# RING_2048 with the body polynomial truncated to 3 limbs: a different
# lattice key (body rounding error enters the phase directly, stdev ~2^-10
# over n=1024 CMUX steps, far below the decoding margin; see
# TfheParams.bk_body_limbs), so it carries its own noise campaign.
RING_2048_FAST = dataclasses.replace(RING_2048, bk_body_limbs=3)

PRESETS = {
    "peba1_128": PEBA1_128,
    "peba1_128_fast": PEBA1_128_FAST,
    "peba1_128_t2": PEBA1_128_T2,
    "ring_2048": RING_2048,
    "ring_2048_fast": RING_2048_FAST,
    "toy": TOY,
    "toy_fast": TOY_FAST,
    "toy_t2": TOY_T2,
    "toy_noisy": TOY_NOISY,
}


@dataclasses.dataclass(frozen=True)
class ProtocolParams:
    """PEBA1 protocol-level constants (reference driver src/main.cpp:30-32,520).

    Attributes:
      nslots: embedding vector length (128 face-embedding slots).
      bitsize: significant bits per slot value.
      max_bitsize: accumulator width of the squared-Euclidean distance
        (hard-coded 24 in the reference, src/Math.cpp:342).
      mul_width: multiplier accumulator width (hard-coded 23 in the reference,
        src/Math.cpp:216).
      bound_match: squared-distance acceptance threshold
        (nslots*2 in the reference driver, src/main.cpp:520).
    """

    nslots: int = 128
    bitsize: int = 8
    max_bitsize: int = 24
    mul_width: int = 23
    bound_match: int = 256


PEBA1_PROTOCOL = ProtocolParams()
