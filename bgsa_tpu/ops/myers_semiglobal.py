"""Full-word Myers block kernel: semi-global and global modes.

Implements the reference generator's full_bits formulation
(``generator/.../MyersGenerator.java:56-223``): Hyyrö's block algorithm with
full 32-bit words and an explicit horizontal delta h in {-1, 0, +1} threaded
between words (here as two 0/1 bit planes; the reference packs h in two's
complement). Semi-global: column boundary h=0 leaves the query-side start
free and the running last-row score is min-tracked (D[i][0] = i, D[0][j] = 0,
result = min_j D[n][j]). Global (``is_global=True``): boundary h=+1, final
last-row score; the engine's kernel route uses it for both Myers modes.

Both backends (XLA scan, Pallas kernel on the Triton route) share the
column body.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from . import blockutil

WORD_BITS = 32  # full words (the reference's full_bits=1 path)
# Largest word count the kernel takes: 94 words (3000 bp), the longest
# subject measured on the card, where the kernel still ran at its 150 bp
# rate and 66x the scan twin (docs/PERF.md). Longer subjects take the twin.
MAX_WORDS = 94


def _column(eq_c, pv, mv, score, min_score, *, read_len, is_global=False):
    """One query-character column over all words.

    eq_c/pv/mv: (W, ...) uint32 arrays or length-W lists of (...) uint32;
    score/min_score: (...) int32. Returns updated (pv_list, mv_list, score,
    min_score).

    The horizontal delta h in {-1, 0, +1} is threaded between words as two
    0/1 planes (hp_in = "h == +1", hn_in = "h == -1") instead of the
    reference's packed two's-complement encoding — saves the encode/decode
    ops on the hot chain (~26% fewer ops/word, +12% measured; exact parity).
    """
    W = len(eq_c)
    one = jnp.uint32(1)
    last_shift = (read_len - 1) % WORD_BITS

    hp_in = jnp.full(eq_c[0].shape, jnp.uint32(1 if is_global else 0))
    hn_in = jnp.zeros(eq_c[0].shape, jnp.uint32)
    new_pv, new_mv = [], []
    for j in range(W):
        pvj, mvj = pv[j], mv[j]
        eq = eq_c[j]
        xv = eq | mvj
        eq = eq | hn_in
        xh = (((eq & pvj) + pvj) ^ pvj) | eq
        ph = ~(xh | pvj) | mvj
        mh = pvj & xh
        if j == W - 1:
            ph_bit = (ph >> last_shift) & one
            mh_bit = (mh >> last_shift) & one
        else:
            # the last word's outgoing horizontal delta is never consumed
            hp_out = ph >> (WORD_BITS - 1)
            hn_out = mh >> (WORD_BITS - 1)
        ph = (ph << 1) | hp_in
        mh = (mh << 1) | hn_in
        new_pv.append(~(xv | ph) | mh)
        new_mv.append(ph & xv)
        if j < W - 1:
            hp_in, hn_in = hp_out, hn_out
    score = score + ph_bit.astype(jnp.int32) - mh_bit.astype(jnp.int32)
    if min_score is None:  # global mode: the running min is dead state
        return new_pv, new_mv, score, None
    min_score = jnp.minimum(min_score, score)
    return new_pv, new_mv, score, min_score


def _column_scan(eq_c, pv, mv, score, min_score, *, read_len, is_global=False):
    """_column with the word loop as a lax.scan (same math, stacked state).

    Keeps the compiled body O(1) in W for the long-subject geometries the
    kernel wrapper routes here (W > MAX_WORDS); the Python loop's unrolled
    jaxpr made those compiles take minutes. Used for W > 64; bit-identical
    to the loop (tests/test_round4_fixes.py).
    """
    W = eq_c.shape[0]
    one = jnp.uint32(1)
    last_shift = (read_len - 1) % WORD_BITS

    def word_step(carry, xs):
        hp_in, hn_in = carry
        eq0, pvj, mvj = xs
        xv = eq0 | mvj
        eq = eq0 | hn_in
        xh = (((eq & pvj) + pvj) ^ pvj) | eq
        ph = ~(xh | pvj) | mvj
        mh = pvj & xh
        ph_bit = (ph >> last_shift) & one  # consumed only for the last word
        mh_bit = (mh >> last_shift) & one
        hp_out = ph >> (WORD_BITS - 1)
        hn_out = mh >> (WORD_BITS - 1)
        ph = (ph << 1) | hp_in
        mh = (mh << 1) | hn_in
        npv = ~(xv | ph) | mh
        nmv = ph & xv
        return (hp_out, hn_out), (npv, nmv, ph_bit, mh_bit)

    hp0 = jnp.full(eq_c.shape[1:], jnp.uint32(1 if is_global else 0))
    hn0 = jnp.zeros(eq_c.shape[1:], jnp.uint32)
    _, (npv, nmv, ph_bits, mh_bits) = lax.scan(word_step, (hp0, hn0), (eq_c, pv, mv))
    score = score + ph_bits[W - 1].astype(jnp.int32) - mh_bits[W - 1].astype(jnp.int32)
    if min_score is None:
        return npv, nmv, score, None
    return npv, nmv, score, jnp.minimum(min_score, score)


@functools.partial(jax.jit, static_argnames=("read_len", "factor", "is_global"))
def myers_semiglobal_xla(eq, queries, *, read_len: int, factor: int = -1, is_global: bool = False):
    """Portable backend. eq (5, W, S) uint32 (32-bit packing), queries (Q, m)."""
    W, S = eq.shape[1], eq.shape[2]

    def column_fn(eq_c, pv, mv, score, mins):
        if W <= 64:
            npv, nmv, score, mins = _column(
                eq_c, pv, mv, score, mins, read_len=read_len, is_global=is_global
            )
            return jnp.stack(npv), jnp.stack(nmv), score, mins
        return _column_scan(
            eq_c, pv, mv, score, mins, read_len=read_len, is_global=is_global
        )

    def one_query(query):
        def step(carry, c):
            pv, mv, score = carry[:3]
            mins = None if is_global else carry[3]
            eq_c = lax.dynamic_index_in_dim(eq, c, axis=0, keepdims=False)
            npv, nmv, score, mins = column_fn(eq_c, pv, mv, score, mins)
            out = (npv, nmv, score)
            return (out if is_global else out + (mins,)), None

        pv0 = jnp.full((W, S), jnp.uint32(0xFFFFFFFF))
        mv0 = jnp.zeros((W, S), jnp.uint32)
        score0 = jnp.full((S,), read_len, jnp.int32)
        carry0 = (pv0, mv0, score0) if is_global else (pv0, mv0, score0, score0)
        carry, _ = lax.scan(step, carry0, query)
        result = carry[2] if is_global else carry[3]
        return result * jnp.int32(factor)

    return jax.vmap(one_query)(queries)


def _kernel(q_ref, eq_ref, out_ref, *, read_len, factor, q_len, is_global):
    W = eq_ref.shape[1]
    B = out_ref.shape[-1]

    def column(i, state):
        pv, mv, score, mins = state
        c = q_ref[i]
        eq_c = [eq_ref[c, w, :] for w in range(W)]
        return _column(
            eq_c, pv, mv, score, mins, read_len=read_len, is_global=is_global
        )

    pv0 = [jnp.full((B,), jnp.uint32(0xFFFFFFFF)) for _ in range(W)]
    mv0 = [jnp.zeros((B,), jnp.uint32) for _ in range(W)]
    score0 = jnp.full((B,), read_len, jnp.int32)
    state = (pv0, mv0, score0, None if is_global else score0)
    _, _, score, mins = lax.fori_loop(0, q_len, column, state)
    out_ref[...] = (score if is_global else mins) * jnp.int32(factor)


@functools.partial(
    jax.jit, static_argnames=("read_len", "factor", "interpret", "is_global")
)
def myers_semiglobal(eq, queries, *, read_len: int, factor: int = -1,
                     interpret: bool = False, is_global: bool = False):
    """Pallas kernel (Triton route). eq (5, W, S) uint32 (32-bit packing)
    -> (Q, S) int32. Past MAX_WORDS words (the longest subject measured
    on the card) the scan twin runs instead (any word count, same
    scores)."""
    W = eq.shape[1]
    Q, m = queries.shape
    if W > MAX_WORDS:
        return myers_semiglobal_xla(
            eq, queries, read_len=read_len, factor=factor, is_global=is_global
        )
    return blockutil.subject_block_call(
        functools.partial(
            _kernel, read_len=read_len, factor=factor, q_len=m,
            is_global=is_global,
        ),
        queries, eq, interpret=interpret, name="myers_fullword",
    )
