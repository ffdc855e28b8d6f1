"""Exact behavioral model of the reference's banded Myers kernel.

A pure-Python bit-level port of ``/root/reference/banded/BGSA_CPU/align_core.c``
(Hyyro's banded approximate-matching recurrence with batched early
termination), used as the golden model for the kernels and by tests. Slow
— one subject at a time with Python ints — but exact.

Key semantics (band fits one word):
  * band_length = threshold + h_threshold + 1, h_threshold = k + slen - qlen;
  * Peq window: subject[0..k-1] pre-shifted to bits k+1..2k (word 0 of the
    banded packing, banded global.c:27-85), subsequent subject bits injected
    at band_down as the band slides;
  * err accumulates 1 - D0&1 per column from column k on; early termination
    latches score 127 when err > threshold + h_threshold + 1 at checkpoint
    columns (after column min(64, qlen), then every 16 columns, then at
    column qlen - k — the 64-bit reference schedule, which we replicate
    independently of our own word size);
  * epilogue scans h_threshold+1 band bits of VP/VN for the min last-row err.

Divergence from the reference (documented): when the reference would read
past the subject's packed bits (qlen > slen, or the injection overrun for
qlen < 64 + k), it consumes adjacent-memory garbage; we inject zero bits
instead. For the read-verification workload (qlen >= 64 + k, qlen <= slen)
the behaviors are identical.
"""

from __future__ import annotations

MAX_ERROR = 127
BATCH = 16
REF_WORD = 64  # checkpoint schedule follows the 64-bit reference port


def checkpoint_columns(qlen: int, slen: int, k: int) -> set[int]:
    """Column counts after which the reference checks err > max_err."""
    h = k + slen - qlen
    cols = {min(REF_WORD, qlen)}
    if qlen > REF_WORD:
        rest = slen - h - REF_WORD  # = qlen - k - REF_WORD (may be negative)
        nbatches = max(rest // BATCH, 0) if rest >= 0 else 0
        for t in range(1, nbatches + 1):
            cols.add(REF_WORD + BATCH * t)
        cols.add(max(qlen - k, REF_WORD))
    return {c for c in cols if c <= qlen}


def banded_score(query, subject, k: int) -> int:
    """Score one (query, subject) pair: min banded err, or 127 on early exit."""
    qlen, slen = len(query), len(subject)
    h = k + slen - qlen
    if h < 0:
        raise ValueError("subject shorter than query - threshold: band invalid")
    band_length = k + h + 1
    band_down = band_length - 1
    mask = (1 << 64) - 1  # band arithmetic in one 64-bit word

    # Packed subject bits to inject: subject[k + t] at injection t (zeros
    # beyond the subject end — see module docstring).
    def inj_bit(c, t):
        idx = k + t
        return 1 if idx < slen and subject[idx] == c else 0

    # Initial Peq window: subject[i] at bit k+1+i for i < k.
    peq = [0] * 5
    for i in range(min(k, slen)):
        peq[subject[i]] |= 1 << (k + 1 + i)

    VP = VN = 0
    err = k
    max_err = k + h + 1
    checks = checkpoint_columns(qlen, slen, k)

    for t in range(qlen):
        c = query[t]
        X = peq[c] | VN
        D0 = ((((X & VP) + VP) & mask) ^ VP) | X
        HN = D0 & VP
        HP = ((D0 | VP) ^ mask) | VN
        Xs = D0 >> 1
        VN = Xs & HP
        VP = ((HP | Xs) ^ mask) | HN
        if t >= k:
            err += 1 - (D0 & 1)
        for c2 in range(5):
            peq[c2] >>= 1
        if t < qlen - k:  # injection phase (band still inside the subject)
            for c2 in range(5):
                peq[c2] |= inj_bit(c2, t) << band_down
        if (t + 1) in checks and err > max_err:
            return MAX_ERROR

    min_err = cur = err
    for i in range(h + 1):
        cur += (VP >> i) & 1
        cur -= (VN >> i) & 1
        min_err = min(min_err, cur)
    return min_err


def banded_scores(query, subjects, k: int):
    return [banded_score(query, s, k) for s in subjects]
