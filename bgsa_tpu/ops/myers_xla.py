"""Myers bit-vector edit distance as pure XLA (jnp/lax) ops.

This is the portable backend: the same recurrence the Pallas kernels run,
expressed as a `lax.scan` over query characters so it compiles on any JAX
backend. Semantics follow the reference's generated reserved-carry multiword
kernel (``/root/reference/original/BGSA_CPU/align_core.c:19-148``): 31 usable
bits per uint32 word, HP/HN shifted across words through a carry chain, the
add's carry confined per word via the reserved top bit, and the running score
tracked at bit ``(read_len-1) % 31`` of the last word.

Shapes: eq (5, W, S) uint32, queries (Q, m) int32 -> scores (Q, S) int32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

WORD_BITS = 31  # usable bits per uint32 word (top bit reserved for the carry)


def _myers_column_scan(eq_c, vp, vn, score, maskh, word_bits):
    """_myers_column with the word loop as a lax.scan (same math).

    The Python word loop unrolls ~10 ops per word into the jaxpr; for long
    subjects (hundreds of words) that made XLA compile times balloon to
    minutes. The scan keeps the
    compiled body O(1) in W. Used for W > 64; bit-identical to the loop
    (tests/test_round4_fixes.py asserts equality across the dispatch
    boundary).
    """
    W = eq_c.shape[0]
    carry_mask = jnp.uint32((1 << word_bits) - 1)
    one = jnp.uint32(1)
    lanes = eq_c.shape[1:]

    def word_step(carry, xs):
        hp_shift, hn_shift, add_carry = carry
        matches, vpj, vnj = xs
        pm = matches | vnj
        s = (vpj & pm) + vpj + add_carry
        add_carry = s >> word_bits
        d0 = ((s & carry_mask) ^ vpj) | pm
        hp = ~(d0 | vpj) | vnj
        hn = d0 & vpj
        hp_bit = hp & maskh  # consumed only for the last word
        hn_bit = hn & maskh
        hp = (hp << 1) | hp_shift
        hp_shift = hp >> word_bits
        hn = (hn << 1) | hn_shift
        hn_shift = hn >> word_bits
        nvp = (~(d0 | hp) | hn) & carry_mask
        nvn = (d0 & hp) & carry_mask
        return (hp_shift, hn_shift, add_carry), (nvp, nvn, hp_bit, hn_bit)

    init = (jnp.full(lanes, one), jnp.zeros(lanes, jnp.uint32),
            jnp.zeros(lanes, jnp.uint32))
    _, (nvp, nvn, hp_bits, hn_bits) = lax.scan(word_step, init, (eq_c, vp, vn))
    hpb, hnb = hp_bits[W - 1], hn_bits[W - 1]
    score = score - (hnb != 0).astype(jnp.int32)
    score = score + jnp.logical_and(hpb != 0, hnb == 0).astype(jnp.int32)
    return nvp, nvn, score


def _myers_column(eq_c, vp, vn, score, maskh, word_bits):
    """One DP column (one query char) over all words; returns updated state.

    eq_c: (W, S) uint32 match vectors for this query char.
    vp, vn: (W, S) uint32 vertical deltas.
    score: (S,) int32 running last-row score.
    """
    W = eq_c.shape[0]
    carry_mask = jnp.uint32((1 << word_bits) - 1)
    one = jnp.uint32(1)

    hp_shift = jnp.full(eq_c.shape[1:], one)
    hn_shift = jnp.zeros(eq_c.shape[1:], jnp.uint32)
    add_carry = jnp.zeros(eq_c.shape[1:], jnp.uint32)
    new_vp = []
    new_vn = []
    for j in range(W):
        matches = eq_c[j]
        vpj, vnj = vp[j], vn[j]
        pm = matches | vnj
        s = (vpj & pm) + vpj + add_carry
        add_carry = s >> word_bits
        d0 = ((s & carry_mask) ^ vpj) | pm
        hp = ~(d0 | vpj) | vnj
        hn = d0 & vpj
        if j == W - 1:
            # Score lives at the subject's last position in the last word.
            score = score - (hn & maskh != 0).astype(jnp.int32)
            score = score + jnp.logical_and(hp & maskh != 0, hn & maskh == 0).astype(jnp.int32)
        hp = (hp << 1) | hp_shift
        hp_shift = hp >> word_bits
        hn = (hn << 1) | hn_shift
        hn_shift = hn >> word_bits
        new_vp.append((~(d0 | hp) | hn) & carry_mask)
        new_vn.append((d0 & hp) & carry_mask)
    return jnp.stack(new_vp), jnp.stack(new_vn), score


@functools.partial(jax.jit, static_argnames=("read_len", "word_bits", "factor"))
def myers_global(eq, queries, *, read_len: int, word_bits: int = WORD_BITS, factor: int = -1):
    """Global unit-cost Myers scores for each (query, subject) pair.

    Args:
      eq: (5, W, S) uint32 packed subject match vectors (see pack.pack_eq).
      queries: (Q, m) int32 query symbol codes.
      read_len: subject length in characters.
      factor: score = factor * edit_distance (reference Main.java factor).

    Returns:
      (Q, S) int32 scores.
    """
    W, S = eq.shape[1], eq.shape[2]
    carry_mask = jnp.uint32((1 << word_bits) - 1)
    maskh = jnp.uint32(1 << ((read_len - 1) % word_bits))
    column = _myers_column if W <= 64 else _myers_column_scan

    def one_query(query):
        def step(carry, c):
            vp, vn, score = carry
            eq_c = lax.dynamic_index_in_dim(eq, c, axis=0, keepdims=False)
            vp, vn, score = column(eq_c, vp, vn, score, maskh, word_bits)
            return (vp, vn, score), None

        vp0 = jnp.full((W, S), carry_mask)
        vn0 = jnp.zeros((W, S), jnp.uint32)
        score0 = jnp.full((S,), read_len, jnp.int32)
        (_, _, score), _ = lax.scan(step, (vp0, vn0, score0), query)
        return score * jnp.int32(factor)

    return jax.vmap(one_query)(queries)
