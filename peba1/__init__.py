"""peba1: TFHE primitive library + PEBA1 protocol layer in JAX.

A from-scratch JAX/XLA reimplementation of everything the reference C++
PEBA1 stack does (protocol layer in-repo + the external libtfhe engine),
redesigned tensor-first: batched gate bootstraps as exact int8 GEMMs,
levelized Boolean circuits, and mesh-sharded encrypted matching.
See SURVEY.md for the blueprint.
"""

from . import gates, keys, lwe, params, tlwe, torus
from .keys import CloudKey, SecretKey, keygen
from .params import PEBA1_128, PEBA1_PROTOCOL, RING_2048, TOY, TOY_NOISY, TfheParams

__version__ = "0.1.0"
