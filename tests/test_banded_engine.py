"""BandedEngine (transport unpack, device packing, banded_xla) against the
banded_ref golden model on the read-filter mix and across the subject
transports."""

import numpy as np
import pytest

from bgsa_tpu import banded_ref, pack
from bgsa_tpu.benchutil import filter_mix_dataset

from test_banded import make_case


def _engine(k):
    from bgsa_tpu.banded_pipeline import BandedEngine
    from bgsa_tpu.pipeline import PipelineConfig

    return BandedEngine(k, PipelineConfig())


def _want(q, s, k):
    return np.stack([banded_ref.banded_scores(qi, s, k) for qi in q])


def test_engine_filter_mix_matches_reference(rng):
    # the k=8/150bp read-filter mix at a subject count that is not a
    # multiple of the 128-subject pad unit; both outcomes occur
    q, s = filter_mix_dataset(rng, 2, 300, 150)
    got = np.asarray(_engine(8).scores(q, s))
    assert got.shape == (2, 300) and got.dtype == np.int8
    np.testing.assert_array_equal(got, _want(q, s, 8))
    assert (got == banded_ref.MAX_ERROR).any() and (got < 9).any()


def test_engine_all_garbage_reports_max_error(rng):
    # random subjects die at a checkpoint: MAX_ERROR for every dead lane,
    # exact scores for any straggler
    q = rng.integers(0, 4, size=(2, 150)).astype(np.int32)
    s = rng.integers(0, 4, size=(256, 150)).astype(np.uint8)
    got = np.asarray(_engine(8).scores(q, s))
    np.testing.assert_array_equal(got, _want(q, s, 8))
    assert (got == banded_ref.MAX_ERROR).mean() > 0.9


@pytest.mark.parametrize("n_every,transport", [(0, "2bit"), (97, "2bitN"),
                                               (3, "nib")])
def test_engine_transports_agree(rng, n_every, transport):
    # N-free, rare-N and dense-N subjects ride different transports; the
    # device unpacks each to the same codes, so scores match the reference
    m, n, k = 64, 64, 6
    q, s = make_case(rng, 2, m, 1024, n, k)
    s = s.astype(np.uint8)
    if n_every:
        s.reshape(-1)[::n_every] = 4
    assert pack.select_transport(s)[0] == transport
    got = np.asarray(_engine(k).scores(q, s))
    np.testing.assert_array_equal(got, _want(q, s, k))


def test_engine_reuses_compiled_step(rng):
    # scores() compiles each batch geometry once (AOT) and reuses it
    eng = _engine(4)
    q, s = make_case(rng, 2, 40, 128, 44, 4)
    s = s.astype(np.uint8)
    first = np.asarray(eng.scores(q, s))
    again = np.asarray(eng.scores(q, s))
    assert len(eng._exec) == 1
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(first, _want(q, s, 4))
