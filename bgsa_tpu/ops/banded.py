"""Banded Myers verification (error threshold k) in XLA: banded_xla.

Re-design of the reference's banded family
(``banded/BGSA_CPU/align_core.c:19-253``; semantics documented in
``bgsa_tpu.banded_ref``). Key mapping decisions:

* The reference's 64-bit band register is held as (lo, hi) uint32 pairs —
  the band's above-band carry dynamics are word-size-dependent, so matching
  the reference bit-for-bit requires 64-bit arithmetic (measured: 16% of
  scores diverge if the band is truncated to 32 bits). This also supports
  bands up to 64 bits (k up to ~31 at equal lengths) without enabling
  64-bit types in JAX.
* The reference's ``goto end`` early termination becomes a per-lane dead
  mask latched at the precomputed checkpoint columns (the scalar reference's
  schedule, ``banded_ref.checkpoint_columns``); dead lanes report
  MAX_ERROR=127. As masking it is branch-free and still exact.
* ``banded_xla`` carries the sliding Peq window like the reference (shift +
  inject per column) and covers every geometry, including s_len < q_len.
  It is the engine's only banded route, on every platform.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..banded_ref import MAX_ERROR, checkpoint_columns


def _add64(alo, ahi, blo, bhi):
    lo = alo + blo
    carry = (lo < alo).astype(jnp.uint32)
    return lo, ahi + bhi + carry


def _shr1(lo, hi):
    return (lo >> 1) | (hi << 31), hi >> 1


def _select_plane(planes, c):
    """planes[c] for a traced scalar c, via a select chain over the five
    loop-carried planes."""
    out = planes[0]
    for i in range(1, planes.shape[0]):
        out = jnp.where(c == i, planes[i], out)
    return out


def _banded_column(t, state, c, inj_bits, *, k, m, band_down, max_err, chk):
    """One query column. state tuple of jnp arrays; c traced char; inj_bits
    (5, ...) uint32 0/1 injection bits for this column; chk traced 0/1."""
    plo, phi, vplo, vphi, vnlo, vnhi, err, dead = state
    one = jnp.uint32(1)

    eq_lo = _select_plane(plo, c)
    eq_hi = _select_plane(phi, c)
    xlo, xhi = eq_lo | vnlo, eq_hi | vnhi
    tlo, thi = xlo & vplo, xhi & vphi
    slo, shi = _add64(tlo, thi, vplo, vphi)
    d0lo = (slo ^ vplo) | xlo
    d0hi = (shi ^ vphi) | xhi
    hnlo, hnhi = d0lo & vplo, d0hi & vphi
    hplo, hphi = ~(d0lo | vplo) | vnlo, ~(d0hi | vphi) | vnhi
    xslo, xshi = _shr1(d0lo, d0hi)
    vnlo, vnhi = xslo & hplo, xshi & hphi
    vplo, vphi = ~(hplo | xslo) | hnlo, ~(hphi | xshi) | hnhi

    scored = (t >= k).astype(jnp.int32)
    err = err + scored * (jnp.int32(1) - (d0lo & one).astype(jnp.int32))

    plo, phi = _shr1(plo, phi)  # move_peq over all 5 planes at once
    inject = jnp.where(t < m - k, jnp.uint32(1), jnp.uint32(0))
    bits = inj_bits * inject
    if band_down < 32:
        plo = plo | (bits << band_down)
    else:
        phi = phi | (bits << (band_down - 32))

    dead = dead | (chk & (err > jnp.int32(max_err)).astype(jnp.int32))
    return plo, phi, vplo, vphi, vnlo, vnhi, err, dead


def _epilogue(state, *, h, read_len_unused=None):
    _, _, vplo, vphi, vnlo, vnhi, err, dead = state
    one = jnp.uint32(1)
    mn = err
    cur = err
    for i in range(h + 1):
        vp_bit = (vplo >> i) & one if i < 32 else (vphi >> (i - 32)) & one
        vn_bit = (vnlo >> i) & one if i < 32 else (vnhi >> (i - 32)) & one
        cur = cur + vp_bit.astype(jnp.int32) - vn_bit.astype(jnp.int32)
        mn = jnp.minimum(mn, cur)
    return jnp.where(dead > 0, jnp.int32(MAX_ERROR), mn)


def _geometry(q_len: int, s_len: int, k: int):
    h = k + s_len - q_len
    if h < 0:
        raise ValueError("banded requires subject_len >= query_len - threshold")
    band_length = k + h + 1
    if band_length > 64:
        raise ValueError(f"band of {band_length} bits exceeds the 64-bit register")
    if k + min(k, s_len) > 63:
        # The initial Peq window holds subject[0..k-1] at bits k+1..2k
        # (banded/BGSA_CPU/global.c:27-85); past bit 63 the packers cannot
        # carry it and the reference's own C is shift-count UB there. Only
        # reachable for s_len < q_len (s_len >= q_len implies 2k < band <= 64).
        raise ValueError(
            f"banded preload needs bit {k + min(k, s_len)} (> 63): threshold "
            f"{k} with {s_len}bp subjects exceeds the 64-bit band register "
            "(undefined in the reference too); reduce -k or use full Myers"
        )
    return h, band_length - 1, k + h + 1  # h, band_down, max_err


def _chk_array(q_len: int, s_len: int, k: int) -> np.ndarray:
    cols = checkpoint_columns(q_len, s_len, k)
    chk = np.zeros(q_len, np.int32)
    for c in cols:
        if 1 <= c <= q_len:
            chk[c - 1] = 1  # check happens after column c (0-based t = c-1)
    return chk


@functools.partial(jax.jit, static_argnames=("q_len", "s_len", "k"))
def banded_xla(init_lo, init_hi, inj, queries, *, q_len: int, s_len: int, k: int):
    """Portable backend. init_* (5, S) uint32, inj (5, W, S) uint32,
    queries (Q, m) int32 -> (Q, S) int32 scores (127 = early exit)."""
    h, band_down, max_err = _geometry(q_len, s_len, k)
    S = init_lo.shape[1]
    W = inj.shape[1]
    chk = jnp.asarray(_chk_array(q_len, s_len, k))
    inj_w_major = jnp.transpose(inj, (1, 0, 2))  # (W, 5, S)

    def one_query(query):
        def step(state, inputs):
            t, c = inputs
            w = jnp.minimum(t // 32, W - 1)
            word = lax.dynamic_index_in_dim(inj_w_major, w, 0, keepdims=False)
            bits = (word >> (t % 32).astype(jnp.uint32)) & jnp.uint32(1)
            state = _banded_column(
                t, state, c, bits, k=k, m=q_len, band_down=band_down,
                max_err=max_err, chk=chk[t],
            )
            return state, None

        zeros = jnp.zeros((S,), jnp.uint32)
        state = (
            init_lo, init_hi, zeros, zeros, zeros, zeros,
            jnp.full((S,), k, jnp.int32), jnp.zeros((S,), jnp.int32),
        )
        ts = jnp.arange(q_len)
        state, _ = lax.scan(step, state, (ts, query))
        return _epilogue(state, h=h)

    return jax.vmap(one_query)(queries)
