"""Subject-block launch shared by the Pallas kernels (Triton route).

Every kernel has the standard GPU shape of a bit-parallel aligner: a grid
over (subject blocks, queries); each program scores one query against
``block`` subjects laid across its threads, keeps that block's bit-vector
state in registers (a Python list of ``(block,)`` uint32 vectors) for the
whole query, loops over query characters inside the kernel, and reads
only the Eq words of each column from memory. The subject axis is the
last axis of every operand and is zero-padded to a block multiple; pad
scores are computed and sliced off.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Subjects per program: one per thread of a 4-warp block. Triton blocks
# must be powers of two.
BLOCK = 128
NUM_WARPS = 4
NUM_STAGES = 1


def padded_subjects(s: int, block: int = BLOCK) -> int:
    """Subject count rounded up to a whole number of blocks."""
    return -(-s // block) * block


def pad_subjects(arr, block: int = BLOCK):
    """Zero-pad ``arr``'s last (subject) axis up to a block multiple."""
    s = arr.shape[-1]
    sp = padded_subjects(s, block)
    if sp == s:
        return arr
    return jnp.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(0, sp - s)])


def subject_block_call(kernel, queries, data, *, interpret: bool = False,
                       name: str | None = None):
    """Launch ``kernel(q_ref, data_ref, out_ref)`` over (subject blocks,
    queries).

    queries: (Q, m) codes; ``q_ref`` is this program's (m,) query row, read
    one scalar per column. data: (..., S) uint32 with subjects last;
    ``data_ref`` is the (..., block) slice of this program's block.
    ``out_ref`` is (block,) int32. Returns (Q, S) int32. Block size, warps
    and pipeline stages are the module's BLOCK, NUM_WARPS and NUM_STAGES.
    """
    block = BLOCK
    if block & (block - 1):
        raise ValueError(f"block {block} must be a power of two")
    Q, m = queries.shape
    S = data.shape[-1]
    data = pad_subjects(data, block)
    lead = data.shape[:-1]
    nb = data.shape[-1] // block
    zeros = (0,) * len(lead)
    out = pl.pallas_call(
        kernel,
        grid=(nb, Q),
        in_specs=[
            pl.BlockSpec((None, m), lambda b, q: (q, 0)),
            pl.BlockSpec(lead + (block,), lambda b, q: zeros + (b,)),
        ],
        out_specs=pl.BlockSpec((None, block), lambda b, q: (q, b)),
        out_shape=jax.ShapeDtypeStruct((Q, nb * block), jnp.int32),
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name=name,
    )(jnp.asarray(queries, jnp.int32), data)
    return out[..., :S]
