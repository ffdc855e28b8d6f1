import numpy as np
import pytest

from bgsa_tpu import banded_ref, pack
from bgsa_tpu.ops import banded as banded_ops


def make_case(rng, Q, m, S, n, k):
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n))
    # half near-matches so a mix of real scores and 127s is produced
    for i in range(S // 2):
        t = np.zeros(n, np.int64)
        t[: min(m, n)] = q[i % Q][: min(m, n)]
        if n > m:
            t[m:] = rng.integers(0, 4, n - m)
        for _ in range(rng.integers(0, k + 5)):
            t[rng.integers(0, n)] = rng.integers(0, 4)
        s[i] = t
    return q, s


@pytest.mark.parametrize("m,n,k", [
    (100, 100, 4), (150, 150, 8), (40, 50, 12), (150, 155, 20),
    # the read-filter geometries
    (150, 158, 8),   # longer subjects: a 25-bit band
    (150, 150, 15),  # 31-bit band
    (70, 70, 8),
    (500, 500, 8),   # long reads, many checkpoints
    (72, 76, 4),
    (40, 48, 4),     # q_len < 64: the only checkpoint is q_len
    (96, 128, 6),    # h >> k: a 45-bit band
    (80, 80, 16),    # 33-bit band: the hi word
    (250, 250, 8),
    (150, 160, 12),
])
def test_xla_matches_bitport(rng, m, n, k):
    q, s = make_case(rng, 2, m, 16, n, k)
    lo, hi, inj = pack.pack_banded(s, k, m)
    got = np.asarray(banded_ops.banded_xla(lo, hi, inj, q, q_len=m, s_len=n, k=k))
    want = np.array([banded_ref.banded_scores(qi, s, k) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_wide_band_hi_word(rng):
    # band_down >= 32: injection lands in the hi word
    m, n, k = 80, 100, 20  # band = 2*20 + 20 + 1 = 61 bits
    q, s = make_case(rng, 2, m, 8, n, k)
    lo, hi, inj = pack.pack_banded(s, k, m)
    got = np.asarray(banded_ops.banded_xla(lo, hi, inj, q, q_len=m, s_len=n, k=k))
    want = np.array([banded_ref.banded_scores(qi, s, k) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_pallas_matches_bitport(rng):
    # the k=8/150bp filter geometry through the engine (banded_xla on
    # every platform)
    m, n, k = 150, 150, 8
    q, s = make_case(rng, 2, m, 3 * 128, n, k)
    got = _engine_scores(q, s, k).astype(np.int32)
    want = np.array([banded_ref.banded_scores(qi, s, k) for qi in q])
    np.testing.assert_array_equal(got, want)
    assert (got == 127).any() and (got != 127).any()  # both outcomes exercised


def test_band_too_wide_raises(rng):
    # k=20, subjects 45bp longer than queries: band 86 > 64 while the
    # preload (bit 41) fits — exercises the band check specifically.
    q, s = make_case(rng, 1, 100, 8, 145, 20)
    lo, hi, inj = pack.pack_banded(s, 20, 100)
    with pytest.raises(ValueError, match="band of 86"):
        banded_ops.banded_xla(lo, hi, inj, q, q_len=100, s_len=145, k=20)


def _engine_scores(q, s, k):
    """BandedEngine scores: transport unpack, device Peq packing and
    banded_xla, the engine's one banded route."""
    from bgsa_tpu.banded_pipeline import BandedEngine
    from bgsa_tpu.pipeline import PipelineConfig

    eng = BandedEngine(k, PipelineConfig())
    return np.asarray(eng.scores(q, s.astype(np.uint8)))


class TestBandedStream:
    """Geometries with s_len >= q_len through the engine vs the behavioral
    reference: narrow bands, wide ones (band 32..63 bits, the hi word) and
    a full 64-bit band."""

    def _check(self, rng, Q, m, S, n, k):
        from bgsa_tpu.banded_ref import banded_scores

        q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
        s = rng.integers(0, 4, size=(S, n))
        s[: S // 3, : min(m, n)] = q[0][: min(m, n)]  # some near-hits
        want = np.stack([banded_scores(qi, s, k) for qi in q])
        np.testing.assert_array_equal(_engine_scores(q, s, k), want)

    def test_equal_lengths(self, rng):
        self._check(rng, 2, 64, 256, 64, 6)

    def test_subject_longer(self, rng):
        self._check(rng, 2, 64, 256, 80, 8)  # h > k: a 33-bit band

    def test_subject_shorter_rejected(self, rng):
        # subjects shorter than query - k (h < 0) have no band: the engine
        # rejects them loudly instead of scoring garbage
        q = rng.integers(0, 4, size=(1, 80)).astype(np.int32)
        s = rng.integers(0, 4, size=(128, 64))
        with pytest.raises(ValueError, match="subject_len >= query_len"):
            _engine_scores(q, s, 8)

    def test_engine_fallback_subject_shorter(self, rng, tmp_path):
        # pipeline-level: shorter subjects route to banded_xla
        self._check(rng, 2, 70, 128, 64, 8)

    def test_band_at_64_limit(self, rng):
        # band_length = k + h + 1 = 64 exactly: the full register
        m, k = 100, 31
        n = m + 1  # h = 32
        self._check(rng, 2, m, 256, n, k)

    def test_band_at_63(self, rng):
        # band_down = 62: one bit below the full register
        self._check(rng, 2, 100, 256, 100, 31)

    def test_tiny_threshold(self, rng):
        self._check(rng, 2, 150, 256, 150, 1)

    def test_block_exit_off_matches_on(self, rng):
        # The early-exit latch is outcome-neutral: with mixed data (some
        # lanes die early, some survive) the engine (device packing) equals
        # banded_xla on the host packing and the reference.
        from bgsa_tpu.banded_ref import banded_scores

        Q, m, S, n, k = 2, 100, 256, 110, 8
        q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
        s = rng.integers(0, 4, size=(S, n))
        s[: S // 3, :m] = q[0]
        on = _engine_scores(q, s, k)
        lo, hi, inj = pack.pack_banded(s, k, m)
        off = np.asarray(banded_ops.banded_xla(lo, hi, inj, q, q_len=m,
                                               s_len=n, k=k))
        np.testing.assert_array_equal(on, off)
        want = np.stack([banded_scores(qi, s, k) for qi in q])
        np.testing.assert_array_equal(on, want)


class TestBandedStreamDual:
    """s_len < q_len (h < k) — the geometries the dual-stream kernel once
    served — now run banded_xla through the engine; parity vs the
    behavioral reference."""

    def _check(self, rng, Q, m, S, n, k):
        from bgsa_tpu.banded_ref import banded_scores

        q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
        s = rng.integers(0, 4, size=(S, n))
        s[: S // 3, : min(m, n)] = q[0][: min(m, n)]  # some near-hits
        want = np.stack([banded_scores(qi, s, k) for qi in q])
        np.testing.assert_array_equal(_engine_scores(q, s, k), want)

    def test_subject_shorter(self, rng):
        self._check(rng, 2, 70, 256, 64, 8)  # h = 2 < k

    def test_h_zero(self, rng):
        self._check(rng, 2, 72, 256, 64, 8)  # h = 0: tightest band

    def test_just_below_equal(self, rng):
        self._check(rng, 2, 65, 256, 64, 6)  # h = 5

    def test_wide_band_hi_word(self, rng):
        self._check(rng, 2, 110, 256, 100, 24)  # h = 14, band_down = 38

    def test_small_k_small_band(self, rng):
        self._check(rng, 2, 66, 256, 64, 3)  # h = 1, 2k < 32

    def test_unrolled(self, rng):
        self._check(rng, 2, 70, 128, 64, 8)

    def test_unrolled_head_remainder(self, rng):
        self._check(rng, 2, 41, 128, 30, 20)  # q_len 41 < 2k + 1

    def test_matches_equal_length_stream(self, rng):
        # h == k boundary: the engine and banded_xla on the host packing
        # must agree
        m = n = 64
        k = 6
        q = rng.integers(0, 4, size=(2, m)).astype(np.int32)
        s = rng.integers(0, 4, size=(256, n))
        one = _engine_scores(q, s, k)
        lo, hi, inj = pack.pack_banded(s, k, m)
        two = np.asarray(banded_ops.banded_xla(lo, hi, inj, q, q_len=m,
                                               s_len=n, k=k))
        np.testing.assert_array_equal(one, two)

    def test_widest_supported_k(self, rng):
        # k=31, h=30: band_down = 61, 2k = 62
        self._check(rng, 2, 100, 128, 99, 31)

    def test_preload_past_window_rejected(self, rng):
        # 2k > 63 with s_len >= k: the preload exceeds the 64-bit register
        # (reference UB too) — rejected by _geometry.
        s = rng.integers(0, 4, size=(128, 99))
        with pytest.raises(ValueError, match="preload"):
            pack.pack_banded_jax(s, 32, 100)

    def test_dual_rejects_wide_k_small_subjects(self, rng):
        # s_len < k keeps the preload in range (bit k + s_len = 60):
        # banded_xla serves the corner and matches the reference.
        self._check(rng, 2, 55, 128, 20, 40)


class TestPreloadOverflow:
    """k + min(k, s_len) > 63: the 64-bit Peq preload cannot hold the first
    k subject chars (bits k+1..2k). Round 3 found the Peq-carry path
    silently truncating here (scores diverged from banded_ref); the
    reference's own C is shift-count UB in this corner, so every entry
    point now rejects it loudly."""

    def test_geometry_rejects(self):
        with pytest.raises(ValueError, match="preload"):
            banded_ops._geometry(100, 65, 40)  # band 46 fits, preload bit 80

    def test_packers_reject(self, rng):
        s = rng.integers(0, 4, size=(128, 65)).astype(np.uint8)
        with pytest.raises(ValueError, match="preload"):
            pack.pack_banded(s, 40, 100)
        with pytest.raises(ValueError, match="preload"):
            pack.pack_banded_jax(s, 40, 100)

    def test_small_subject_carry_corner_still_works(self, rng):
        # 2k > 63 but s_len < k keeps the preload at bit k+s_len <= 63:
        # the Peq-carry fallback remains valid there and matches the golden.
        k, m, n = 40, 55, 20  # h=5, band=46, preload top bit 60
        q = rng.integers(0, 4, size=(2, m)).astype(np.int32)
        s = rng.integers(0, 4, size=(128, n)).astype(np.uint8)
        want = np.array([banded_ref.banded_scores(qq, s, k) for qq in q])
        lo, hi, inj = pack.pack_banded(s, k, m)
        got = np.asarray(banded_ops.banded_xla(lo, hi, inj, q, q_len=m, s_len=n, k=k))
        np.testing.assert_array_equal(got, want)


def test_engine_routes_stream_and_peq_carry(rng):
    """BandedEngine, engine-level: the s_len >= q_len geometry and the
    2k > 63, s_len < k corner (the Peq-carry recurrence), both on
    banded_xla."""
    from bgsa_tpu.banded_pipeline import BandedEngine
    from bgsa_tpu.banded_ref import banded_scores
    from bgsa_tpu.pipeline import PipelineConfig

    cfg = PipelineConfig()

    # s >= q
    q = rng.integers(0, 4, size=(2, 64)).astype(np.int32)
    s = rng.integers(0, 4, size=(128, 80))
    got = np.asarray(BandedEngine(6, cfg).scores(q, s.astype(np.uint8)))
    want = np.stack([banded_scores(qi, s, 6) for qi in q])
    np.testing.assert_array_equal(got, want)

    # 2k > 63 with s < k: banded_xla (preload k+s = 60 fits)
    q = rng.integers(0, 4, size=(2, 50)).astype(np.int32)
    s = rng.integers(0, 4, size=(128, 20))
    got = np.asarray(BandedEngine(40, cfg).scores(q, s.astype(np.uint8)))
    want = np.stack([banded_scores(qi, s, 40) for qi in q])
    np.testing.assert_array_equal(got, want)
