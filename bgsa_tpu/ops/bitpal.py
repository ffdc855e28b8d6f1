"""BitPAl general integer scoring (match M, mismatch I, gap G), non-packed.

Implements the BitPAl algorithm (Loving, Hernandez & Benson 2014) in its
non-packed representation: one indicator bitvector per distinct vertical-delta
value v in [G, M-G] over the subject rows. The reference emits this kernel
from Java at codegen time (``generator/.../BitPAlGenerator.java:1392-1703``,
``genUnpackedCommon``); here the same value-class network is built at trace
time as a function of (M, I, G) — the loops that the reference's emitter
unrolls into C source become Python loops emitting jnp ops.

Conventions (mirroring the generated kernels' bit layout so scores agree
exactly): uint32 words, 31 usable bits (top bit reserved for the in-word add
carry), per-column cross-word carries for the run-propagation adds and the
one-row shifts. ``word_bits=32`` selects the full-word compare-carry layout
— the unpacked half of the generator's "carry" path
(``BitPAlGenerator.genKernel:39-64`` x KNCArch ``isCarry``), completing G8's
six emission paths (the packed half is
``bitpal_packed word_bits=32``; A/B numbers in docs/PERF.md). Requires
M > I > 2G (the value-class lattice the algorithm assumes;
schemes.normalize enforces it).

The final score is S[n][m] = G*m + sum_i DV[i][m]; instead of the reference's
bit-serial walk we use a per-plane popcount (lax.population_count), masked to
the valid subject rows. Semi-global (max over subject prefixes) uses a
bit-serial prefix walk.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax

WORD_BITS = 31


@dataclasses.dataclass(frozen=True)
class BitpalParams:
    match: int
    mismatch: int
    gap: int

    def __post_init__(self):
        if not (self.match > self.mismatch > 2 * self.gap):
            raise ValueError(
                f"BitPAl requires M > I > 2G, got ({self.match},{self.mismatch},{self.gap})"
            )

    @property
    def minv(self) -> int:  # lowest delta value = G
        return self.gap

    @property
    def maxv(self) -> int:  # highest delta value = M - G
        return self.match - self.gap

    @property
    def midv(self) -> int:  # mismatch class = I - G
        return self.mismatch - self.gap

    @property
    def max_sub_mid(self) -> int:
        return self.maxv - self.midv

    @property
    def values(self):
        return range(self.minv, self.maxv + 1)


def _bitpal_column(planes, matches_w, p: BitpalParams,
                   word_bits: int = WORD_BITS):
    """One query column over all words.

    planes: dict value -> list of per-word arrays (vertical-delta indicators).
    matches_w: list of per-word match bitvectors for this column's character.
    Returns the new planes dict.

    ``word_bits=32`` is the full-word compare-carry variant — the unpacked
    twin of ``bitpal_packed``'s KNC hardware-adc analogue (the generator's
    unpacked "carry" path, ``BitPAlGenerator.genKernel:39-64`` x KNCArch):
    all 32 bits hold subject rows, the run-propagation adds recover their
    cross-word carry with unsigned compares (``sum < addend``) instead of
    the reserved bit, and the one-row shifts extract bit 31. Identical
    scores either way.
    """
    W = len(matches_w)
    full = word_bits == 32
    minv, midv, maxv = p.minv, p.midv, p.maxv
    CM = jnp.uint32((1 << word_bits) - 1 if not full else 0xFFFFFFFF)
    zeros = jnp.zeros_like(matches_w[0])

    overflow = {}

    def add3(a, b, key):
        """a + b + overflow[key] with the cross-word carry captured back
        into ``overflow[key]``."""
        cin = overflow.get(key, zeros)
        if full:
            s1 = a + b
            s = s1 + cin
            # carry-out of the 32-bit chain: the partial adds cannot both
            # wrap, so OR of the compares is exact.
            overflow[key] = ((s1 < a) | (s < s1)).astype(jnp.uint32)
        else:
            s = a + b + cin
            overflow[key] = s >> word_bits
        return s

    prevbit = {v: zeros for v in p.values}
    out = {v: [] for v in p.values}

    for w in range(W):
        dh = {v: planes[v][w] for v in p.values}
        matches = matches_w[w]
        not_matches = ~matches

        # ---- Phase A: horizontal-delta ("dv_shift") indicators ----
        dv_shift = {}
        dvsnm = {}  # dv_<v>_shift & not_matches
        init_max = dh[minv] & matches
        s = add3(init_max, dh[minv], 0)
        dv_shift[maxv] = (s ^ dh[minv] ^ init_max) & CM
        remain = (init_max & CM) ^ dh[minv]
        dv_max_or_match = dv_shift[maxv] | matches

        oi = 1
        for i in range(maxv - 1, midv, -1):
            cnt = minv + (maxv - i)
            init_i = dh[cnt] & dv_max_or_match
            for x in range(1, maxv - i):
                init_i = init_i | (dh[cnt - x] & dvsnm[maxv - x])
            # bit that leaves the word on the one-row shift (the 31-bit
            # layout's bit 30; bit 31 with full words)
            nxt = (init_i & CM) >> (word_bits - 1)
            init_val = ((init_i << 1) | prevbit[i]) & CM
            prevbit[i] = nxt
            s = add3(init_val, remain, oi)
            dv_shift[i] = s ^ remain
            dvsnm[i] = dv_shift[i] & not_matches
            oi += 1

        if maxv > midv + 1:
            acc = dv_max_or_match
            for i in range(maxv - 1, midv, -1):
                acc = acc | dv_shift[i]
            dv_not_hi = ~acc
        else:
            dv_not_hi = ~dv_max_or_match

        index = minv + p.match - p.mismatch
        for i in range(midv, minv, -1):
            init_i = dh[index] & dv_max_or_match
            dhi = index - 1
            for j in range(maxv - 1, midv, -1):
                init_i = init_i | (dh[dhi] & dvsnm[j])
                dhi -= 1
            init_i = init_i | (dh[dhi] & dv_not_hi)
            dv_shift[i] = (init_i << 1) | prevbit[i]
            prevbit[i] = (init_i & CM) >> (word_bits - 1)
            index += 1

        acc = dv_shift[maxv]
        for i in range(maxv - 1, minv, -1):
            acc = acc | dv_shift[i]
        dv_shift[minv] = ~acc

        # ---- Phase B: new vertical-delta planes ----
        for i in range(midv + 1, maxv):
            dh[i] = dh[i] & not_matches
        dh_max_or_match = dh[maxv] | matches
        if maxv - 1 > midv:
            acc = dh_max_or_match
            for i in range(maxv - 1, midv, -1):
                acc = acc | dh[i]
            dh_lo_mask = ~acc
        else:
            dh_lo_mask = ~dh_max_or_match

        new = {}
        index = maxv - 1
        for i in range(minv + 1, midv + 1):
            t1 = dv_shift[index] & dh_max_or_match
            dhi = maxv - 1
            for j in range(1, p.max_sub_mid):
                t1 = t1 | (dv_shift[index - j] & dh[dhi])
                dhi -= 1
            new[i] = t1 | (dv_shift[index - p.max_sub_mid] & dh_lo_mask)
            index -= 1

        value = p.max_sub_mid
        for i in range(midv + 1, maxv + 1):
            t1 = dv_shift[index] & dh_max_or_match
            dhi = maxv - 1
            for j in range(1, value):
                t1 = t1 | (dv_shift[index - j] & dh[dhi])
                dhi -= 1
            new[i] = t1
            value -= 1
            index -= 1

        acc = new[maxv]
        for i in range(maxv - 1, minv, -1):
            acc = acc | new[i]
        new[minv] = (~acc) & CM

        for v in p.values:
            out[v].append(new[v])

    return out


def popcount(x):
    """Set bits of a uint32 array as int32. Counted on the int32 bit
    pattern: the Triton route lowers a 32-bit signed popcount to the
    hardware instruction but cannot legalize the unsigned one."""
    return lax.population_count(lax.bitcast_convert_type(x, jnp.int32))


def _valid_masks(read_len: int, W: int, word_bits: int = WORD_BITS):
    masks = []
    for w in range(W):
        bits = min(read_len - w * word_bits, word_bits)
        masks.append(jnp.uint32((1 << max(bits, 0)) - 1
                                if bits < 32 else 0xFFFFFFFF))
    return masks


def _global_score(planes, p: BitpalParams, read_len: int, q_len: int, factor: int,
                  word_bits: int = WORD_BITS):
    """S[n][m] = G*m + sum of final-column vertical deltas (weighted popcount)."""
    W = len(planes[p.minv])
    masks = _valid_masks(read_len, W, word_bits)
    score = jnp.full_like(planes[p.minv][0], p.gap * q_len, jnp.int32)
    score = score.astype(jnp.int32)
    for v in p.values:
        if v == 0:
            continue
        cnt = None
        for w in range(W):
            c = popcount(planes[v][w] & masks[w])
            cnt = c if cnt is None else cnt + c
        score = score + jnp.int32(v) * cnt
    return score * jnp.int32(factor)


def _semiglobal_score(planes, p: BitpalParams, read_len: int, q_len: int, factor: int,
                      word_bits: int = WORD_BITS):
    """max over subject prefixes: bit-serial walk down the final column."""
    W = len(planes[p.minv])
    one = jnp.uint32(1)
    score = jnp.full_like(planes[p.minv][0], p.gap * q_len, jnp.int32)
    score = score.astype(jnp.int32)
    best = score
    for w in range(W):
        bits = min(read_len - w * word_bits, word_bits)
        adds = {v: planes[v][w] for v in p.values}
        for b in range(max(bits, 0)):
            delta = jnp.zeros_like(score)
            for v in p.values:
                if v == 0:
                    continue
                delta = delta + jnp.int32(v) * ((adds[v] >> b) & one).astype(jnp.int32)
            score = score + delta
            best = jnp.maximum(best, score)
    return best * jnp.int32(factor)


def _init_planes(p: BitpalParams, shape, W, semi_global: bool,
                 word_bits: int = WORD_BITS):
    CM = jnp.uint32((1 << word_bits) - 1 if word_bits < 32 else 0xFFFFFFFF)
    boundary = 0 if semi_global else p.minv
    planes = {}
    for v in p.values:
        fill = CM if v == boundary else jnp.uint32(0)
        planes[v] = [jnp.full(shape, fill) for _ in range(W)]
    return planes


@functools.partial(
    jax.jit,
    static_argnames=("match", "mismatch", "gap", "read_len", "factor",
                     "semi_global", "word_bits"),
)
def bitpal_xla(eq, queries, *, match: int, mismatch: int, gap: int, read_len: int,
               factor: int = 1, semi_global: bool = False,
               word_bits: int = WORD_BITS):
    """Portable backend. eq (5, W, S) uint32 (packed to ``word_bits`` usable
    bits per word — 31 reserved-carry default, 32 = compare-carry),
    queries (Q, m)."""
    p = BitpalParams(match, mismatch, gap)
    C, W, S = eq.shape
    Q, m = queries.shape
    nvals = p.maxv - p.minv + 1

    def one_query(query):
        def step(carry, c):
            eq_c = lax.dynamic_index_in_dim(eq, c, axis=0, keepdims=False)
            planes = {v: [carry[v - p.minv, w] for w in range(W)] for v in p.values}
            new = _bitpal_column(planes, [eq_c[w] for w in range(W)], p, word_bits)
            stacked = jnp.stack([jnp.stack(new[v]) for v in p.values])
            return stacked, None

        init = _init_planes(p, (S,), W, semi_global, word_bits)
        carry0 = jnp.stack([jnp.stack(init[v]) for v in p.values])
        final, _ = lax.scan(step, carry0, query)
        planes = {v: [final[v - p.minv, w] for w in range(W)] for v in p.values}
        if semi_global:
            return _semiglobal_score(planes, p, read_len, m, factor, word_bits)
        return _global_score(planes, p, read_len, m, factor, word_bits)

    return jax.vmap(one_query)(queries)
