"""BitPAl packed representation: vertical deltas as ceil(log2) bit planes.

The perf variant of ops/bitpal.py: instead of one indicator plane per delta
value (M-2G+1 planes), the state stores each row's delta class in
``maxBitsNum = ceil(log2(M-2G+1))`` two's-complement bit planes (negated
offset encoding: value v is stored as ``-(v - G) mod 2^bits``), and the
column update runs two bit-plane ripple adders plus a small class-decode
network — the structure the reference's generator emits in
``BitPAlGenerator.genPackedCommon`` (cross-checked against its generated
(2,-3,-5) uint32 instance, ``original/BGSA_KNC/align_core.c:19-485``).

Applicability: the packed decode only covers classes [G, I-G], which bounds
the scheme to ``M <= 2I - 2G + 1`` (otherwise the reference generator itself
would emit references to undecoded classes); the engine falls back to the
non-packed kernel outside that range. Scores are identical either way.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from . import blockutil
from .bitpal import BitpalParams, WORD_BITS, _valid_masks, popcount

# Largest state (bit planes x words) the kernel keeps per thread: 5 planes
# x 33 words, (2,-3,-5) at 1000 bp, the longest subject measured on the
# card, where the kernel still ran at its 500 bp rate and 47x the XLA twin
# (docs/PERF.md). Larger states take the twin.
MAX_STATE = 165


def packed_supported(p: BitpalParams) -> bool:
    return p.match <= 2 * p.mismatch - 2 * p.gap + 1


def _bits_num(p: BitpalParams) -> int:
    # ceil(log2(maxLength + 1)) planes for the magnitude plus one for the
    # negated encoding's sign (the generator's maxBitsNum: 5 for (2,-3,-5)).
    max_length = p.maxv - p.minv
    # ceil(log2(max_length + 1)) == max_length.bit_length()
    return max(max_length.bit_length() + 1, 2)


def _packed_column(state_w, matches_w, p: BitpalParams, nbits: int,
                   word_bits: int = WORD_BITS):
    """One query column over all words. state_w: list per word of lists of
    nbits plane arrays. Returns new state (same structure).

    ``word_bits=32`` selects the full-word compare-carry variant — the
    analogue of the reference's KNC hardware add-with-carry kernel
    (``original/BGSA_KNC/align_core.c:1153`` ``_mm512_adc_epi32``; generator
    path ``AVX512Intrinsics.java:92-94``): all 32 bits hold subject rows
    (1/31 fewer words + denser planes) and the inter-word adder carry is
    recovered with unsigned compares (``sum < addend``) instead of the
    reserved bit 31. Identical scores either way.

    Implements the generated network's math
    (``original/BGSA_AVX512/align_core.c:19-485``) with the op-count surgery
    documented in docs/PERF.md:

    * only the low classes phase A consumes ([minv, minv + maxv-midv-1]) are
      decoded through the AND trie; the full low-class union needed by the
      adjustment comes from a plane comparator (stored == 0 or stored >=
      2^n - (midv-minv)) instead of OR-ing per-class decodes;
    * the top plane of the DV encoding is identically zero (maxv - minv <
      2^(nbits-1) by construction), and the clamp zeroes the top sum plane,
      so the generated code's plane-4 adder/clamp/shift ops are dead and
      skipped here;
    * the last word's outgoing cross-word carries (overflow, prevbit,
      rowbit) are never consumed and are not computed.
    """
    W = len(matches_w)
    full = word_bits == 32
    minv, midv, maxv = p.minv, p.midv, p.maxv
    # With full words CM is all-ones and every "& CM" folds away at compile
    # time; only the carry extractions need different code (below).
    CM = jnp.uint32((1 << word_bits) - 1 if not full else 0xFFFFFFFF)
    NEXT_HIGH = jnp.uint32(1 << (word_bits - 1))  # highest subject-row bit
    zeros = jnp.zeros_like(matches_w[0])
    top_plane = nbits - 1

    def add_carry(a, b, cin, key):
        """s = a + b + cin with the cross-word carry captured into
        ``overflow[key]`` (skipped on the last word, whose carry-out is
        never consumed)."""
        if full:
            s1 = a + b
            s = s1 + cin
            if key is not None:
                # carry-out of a 32-bit add chain: the two partial adds
                # cannot both wrap, so OR of the compares is exact.
                overflow[key] = ((s1 < a) | (s < s1)).astype(jnp.uint32)
        else:
            s = a + b + cin
            if key is not None:
                overflow[key] = s >> word_bits
        return s

    overflow = {}
    prevbit = {v: zeros for v in range(midv + 1, maxv + 1)}
    rowbit = [zeros] * top_plane  # cross-word carries of the one-row shift
    out = []

    for w in range(W):
        last_word = w == W - 1
        dhbit = list(state_w[w])
        matches = matches_w[w]
        not_matches = ~matches

        # Decode class indicators for the phase-A classes: value v is stored
        # as two's complement of -(v - minv) across the planes. Prefixes over
        # the high planes are shared across patterns (memoized AND trie) —
        # the naive per-class chains cost ~2x the ops.
        prefix_cache: dict = {}
        inv_cache: dict = {}

        def inv(i):
            if i not in inv_cache:
                inv_cache[i] = ~dhbit[i]
            return inv_cache[i]

        def chain(bits: tuple):
            """Cumulative AND over planes nbits-1 .. nbits-len(bits); bits is
            the pattern slice msb-first, so common high-plane prefixes are
            computed once."""
            if bits in prefix_cache:
                return prefix_cache[bits]
            plane = nbits - len(bits)
            term = dhbit[plane] if bits[-1] else inv(plane)
            if len(bits) > 1:
                term = chain(bits[:-1]) & term
            prefix_cache[bits] = term
            return term

        dh = {}
        for v in range(minv, minv + (maxv - midv)):
            pattern = (-(v - minv)) & ((1 << nbits) - 1)
            bits = tuple((pattern >> i) & 1 for i in reversed(range(nbits)))
            dh[v] = chain(bits)
        dh[minv] = dh[minv] & CM

        # Union of all low classes [minv, midv]: stored == 0 (= dh[minv]'s
        # raw pattern) or stored >= 2^nbits - (midv - minv). The >= is a
        # plane comparator built lsb-first: ge_i = b_i & ge (k-bit 1) or
        # b_i | ge (k-bit 0), with the empty suffix counting as >= (None).
        thresh = (1 << nbits) - (midv - minv)
        ge = None
        for i in range(nbits):
            if (thresh >> i) & 1:
                ge = dhbit[i] if ge is None else dhbit[i] & ge
            elif ge is not None:
                ge = dhbit[i] | ge
        lo_mid = (chain(tuple([0] * nbits)) | ge) & not_matches

        # Phase A: horizontal-delta classes (midv, maxv], same propagation
        # network as the non-packed kernel.
        dv_shift = {}
        init_max = dh[minv] & matches
        s = add_carry(init_max, dh[minv], overflow.get(0, zeros),
                      None if last_word else 0)
        dv_shift[maxv] = (s ^ dh[minv] ^ init_max) & CM
        remain = dh[minv] ^ init_max
        dv_max_or_match = dv_shift[maxv] | matches

        oi = 1
        for i in range(maxv - 1, midv, -1):
            cnt = minv + (maxv - i)
            init_i = dh[cnt] & dv_max_or_match
            for x in range(1, maxv - i):
                init_i = init_i | (dh[cnt - x] & dv_shift[maxv - x])
            if full:
                carry_out = init_i >> 31  # top bit leaves the word pre-shift
                init_val = (init_i << 1) | prevbit[i]
                if not last_word:
                    prevbit[i] = carry_out
            else:
                init_val = (init_i << 1) | prevbit[i]
                if not last_word:
                    prevbit[i] = init_val >> word_bits
                init_val = init_val & CM
            s = add_carry(init_val, remain, overflow.get(oi, zeros),
                          None if last_word else oi)
            dv_shift[i] = (s ^ remain) & not_matches
            oi += 1

        if maxv > midv + 1:
            acc = dv_max_or_match
            for i in range(maxv - 1, midv, -1):
                acc = acc | dv_shift[i]
            dv_not_hi = ~acc
        else:
            dv_not_hi = ~dv_max_or_match

        def dv_name(v):
            if v == midv:
                return dv_not_hi
            if v == maxv:
                return dv_max_or_match
            return dv_shift[v]

        # Encode the horizontal classes into bit planes (mapped = v - minv).
        # The top plane is identically zero: mapped <= maxv - minv <
        # 2^(nbits-1) by _bits_num's construction.
        dv_bit = []
        for i in range(top_plane):
            acc = None
            for v in range(midv, maxv + 1):
                if ((v - minv) >> i) & 1:
                    t = dv_name(v)
                    acc = t if acc is None else acc | t
            dv_bit.append(acc if acc is not None else zeros)

        # mapped(DHin) + mapped(DV): bitwise ripple adder over planes; the
        # zero top operand reduces the top plane to dhbit[top] ^ carry, and
        # the final carry-out is never used.
        carry = dhbit[0] & dv_bit[0]
        sumbit = [dhbit[0] ^ dv_bit[0]]
        for i in range(1, top_plane):
            x = dhbit[i] ^ dv_bit[i]
            sumbit.append(x ^ carry)
            carry = (dhbit[i] & dv_bit[i]) | (x & carry)
        sum_top = dhbit[top_plane] ^ carry

        # Clamp rows whose sum overflowed (top bit set -> whole row zeroed;
        # the clamped top plane itself is identically zero afterwards), then
        # shift one row up with cross-word rowbit carries.
        comp = ~sum_top
        shifted = []
        for i in range(top_plane):
            sb = sumbit[i] & comp
            shifted.append((sb << 1) | rowbit[i])
            if not last_word:
                rowbit[i] = (sb & NEXT_HIGH) >> (word_bits - 1)

        # Subtract mapped(H) at the same row: add its negation, built from
        # the mark patterns (the generator's dhbit adjustment).
        comp_lo_mid = ~lo_mid
        mark1 = midv - minv - 1
        mark2 = (maxv - minv) - 1
        adj = []
        for i in range(nbits):
            b = dhbit[i]
            if (mark1 >> i) & 1:
                b = b & comp_lo_mid
            else:
                b = b | lo_mid
            if (mark2 >> i) & 1:
                b = b & not_matches
            else:
                b = b | matches
            adj.append(b)

        # adj + shifted sum (shifted top plane is zero), masked by the new
        # top bit.
        carry = adj[0] & shifted[0]
        sumbit = [adj[0] ^ shifted[0]]
        for i in range(1, top_plane):
            x = adj[i] ^ shifted[i]
            sumbit.append(x ^ carry)
            carry = (adj[i] & shifted[i]) | (x & carry)
        top = adj[top_plane] ^ carry
        out.append([sb & top for sb in sumbit] + [top])

    return out


def _packed_init(p: BitpalParams, nbits: int, shape, W, semi_global: bool,
                 word_bits: int = WORD_BITS):
    CM = jnp.uint32((1 << word_bits) - 1 if word_bits < 32 else 0xFFFFFFFF)
    if semi_global:
        pattern = p.minv & ((1 << nbits) - 1)  # stored(-(0 - minv)) = minv mod 2^n
    else:
        pattern = 0  # stored value minv (DV = G boundary)
    return [
        [jnp.full(shape, CM if (pattern >> i) & 1 else jnp.uint32(0)) for i in range(nbits)]
        for _ in range(W)
    ]


def _packed_global_score(state_w, p: BitpalParams, nbits: int, read_len,
                         q_len, factor, word_bits: int = WORD_BITS):
    """score = G*m + sum_rows(2^top*b_top - sum_low 2^i*b_i - |G|)."""
    masks = _valid_masks(read_len, len(state_w), word_bits)
    score = jnp.full_like(state_w[0][0], p.gap * q_len + p.gap * read_len, jnp.int32)
    score = score.astype(jnp.int32)
    for w, planes in enumerate(state_w):
        for i in range(nbits):
            c = popcount(planes[i] & masks[w])
            weight = (1 << i) if i == nbits - 1 else -(1 << i)
            score = score + jnp.int32(weight) * c
    return score * jnp.int32(factor)


def _packed_semiglobal_score(state_w, p: BitpalParams, nbits: int, read_len,
                             q_len, factor, word_bits: int = WORD_BITS):
    one = jnp.uint32(1)
    score = jnp.full_like(state_w[0][0], p.gap * q_len, jnp.int32).astype(jnp.int32)
    best = score
    for w, planes in enumerate(state_w):
        bits = min(read_len - w * word_bits, word_bits)
        for b in range(max(bits, 0)):
            delta = jnp.full_like(score, p.gap)
            for i in range(nbits):
                weight = (1 << i) if i == nbits - 1 else -(1 << i)
                delta = delta + jnp.int32(weight) * ((planes[i] >> b) & one).astype(jnp.int32)
            score = score + delta
            best = jnp.maximum(best, score)
    return best * jnp.int32(factor)


@functools.partial(
    jax.jit,
    static_argnames=("match", "mismatch", "gap", "read_len", "factor",
                     "semi_global", "word_bits"),
)
def bitpal_packed_xla(eq, queries, *, match, mismatch, gap, read_len,
                      factor=1, semi_global=False, word_bits=WORD_BITS):
    """Portable backend. eq (5, W, S) uint32 (word_bits packing), queries (Q, m)."""
    p = BitpalParams(match, mismatch, gap)
    if not packed_supported(p):
        raise ValueError(f"packed BitPAl requires M <= 2I - 2G + 1, got {p}")
    nbits = _bits_num(p)
    C, W, S = eq.shape
    Q, m = queries.shape

    def one_query(query):
        def step(carry, c):
            eq_c = lax.dynamic_index_in_dim(eq, c, axis=0, keepdims=False)
            state_w = [[carry[w, i] for i in range(nbits)] for w in range(W)]
            new = _packed_column(state_w, [eq_c[w] for w in range(W)], p, nbits,
                                 word_bits)
            return jnp.stack([jnp.stack(ws) for ws in new]), None

        init = _packed_init(p, nbits, (S,), W, semi_global, word_bits)
        carry0 = jnp.stack([jnp.stack(ws) for ws in init])
        final, _ = lax.scan(step, carry0, query)
        state_w = [[final[w, i] for i in range(nbits)] for w in range(W)]
        if semi_global:
            return _packed_semiglobal_score(state_w, p, nbits, read_len, m,
                                            factor, word_bits)
        return _packed_global_score(state_w, p, nbits, read_len, m, factor,
                                    word_bits)

    return jax.vmap(one_query)(queries)


def _kernel(q_ref, eq_ref, out_ref, *, p, nbits, read_len, q_len, factor,
            semi_global, word_bits=WORD_BITS):
    W = eq_ref.shape[1]
    B = out_ref.shape[-1]

    def column(i, state_w):
        c = q_ref[i]
        return _packed_column(state_w, [eq_ref[c, w, :] for w in range(W)],
                              p, nbits, word_bits)

    init = _packed_init(p, nbits, (B,), W, semi_global, word_bits)
    state_w = lax.fori_loop(0, q_len, column, init)
    score = _packed_semiglobal_score if semi_global else _packed_global_score
    out_ref[...] = score(state_w, p, nbits, read_len, q_len, factor, word_bits)


@functools.partial(
    jax.jit,
    static_argnames=(
        "match", "mismatch", "gap", "read_len", "factor", "semi_global",
        "interpret", "word_bits",
    ),
)
def bitpal_packed(eq, queries, *, match, mismatch, gap, read_len, factor=1,
                  semi_global=False, interpret: bool = False,
                  word_bits: int = WORD_BITS):
    """Pallas kernel (Triton route) -> (Q, S) int32 scores. Past MAX_STATE
    state words per thread (the largest state measured on the card) the
    XLA twin runs instead (any word count, same scores)."""
    p = BitpalParams(match, mismatch, gap)
    if not packed_supported(p):
        raise ValueError(f"packed BitPAl requires M <= 2I - 2G + 1, got {p}")
    nbits = _bits_num(p)
    W = eq.shape[1]
    Q, m = queries.shape
    if nbits * W > MAX_STATE:
        return bitpal_packed_xla(
            eq, queries, match=match, mismatch=mismatch, gap=gap,
            read_len=read_len, factor=factor, semi_global=semi_global,
            word_bits=word_bits,
        )
    return blockutil.subject_block_call(
        functools.partial(
            _kernel, p=p, nbits=nbits, read_len=read_len, q_len=m,
            factor=factor, semi_global=semi_global, word_bits=word_bits,
        ),
        queries, eq, interpret=interpret, name="bitpal_packed",
    )
