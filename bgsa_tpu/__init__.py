"""bgsa_tpu — bit-parallel batch sequence alignment in JAX.

A from-scratch JAX/Pallas re-design of the capabilities of sdu-hpcl/BGSA:
Myers bit-vector edit distance (global/semi-global, multi-word), BitPAl
general integer scoring, and banded Myers verification — one parameterized
kernel family instead of ten per-architecture C ports plus a Java generator.
"""

from .api import align, encode_sequences
from .schemes import Algorithm, Mode, NormalizedScheme, Scoring, normalize

__all__ = [
    "Algorithm",
    "Mode",
    "NormalizedScheme",
    "Scoring",
    "align",
    "encode_sequences",
    "normalize",
]

__version__ = "0.2.0"
