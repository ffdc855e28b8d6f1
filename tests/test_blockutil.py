"""Subject blocks and kernel routing: awkward subject counts must not break
the kernel wrappers, the word-count limits must route long subjects to the
XLA twins, and every kernel must lower for the GPU's Triton route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bgsa_tpu import oracle, pack
from bgsa_tpu.ops import blockutil
from bgsa_tpu.schemes import Mode, Scoring


def test_choose_rows():
    # subject counts round up to whole blocks of BLOCK (a power of two)
    B = blockutil.BLOCK
    assert B & (B - 1) == 0
    assert blockutil.padded_subjects(1) == B
    assert blockutil.padded_subjects(B) == B
    assert blockutil.padded_subjects(B + 1) == 2 * B
    assert blockutil.padded_subjects(760576) == 760576  # a full 150 bp bucket
    x = np.ones((5, 3, 200), np.uint32)
    padded = np.asarray(blockutil.pad_subjects(x))
    assert padded.shape == (5, 3, 2 * B)
    assert (padded[..., 200:] == 0).all() and (padded[..., :200] == 1).all()


def test_kernel_wrappers_reject_non_lane_multiple_subjects(rng):
    """Ragged subject counts are padded to a block and sliced back: every
    wrapper returns exactly S scores per query."""
    from bgsa_tpu.ops import bitpal_packed, myers_semiglobal

    s = rng.integers(0, 4, size=(100, 40))  # not a multiple of the block
    q = rng.integers(0, 4, size=(1, 40)).astype(np.int32)
    eq31, eq32 = pack.pack_eq(s, 31), pack.pack_eq(s, 32)
    got = np.asarray(myers_semiglobal.myers_semiglobal(
        eq32, q, read_len=40, is_global=True, interpret=True))
    assert got.shape == (1, 100)
    np.testing.assert_array_equal(got[0], -oracle.edit_distances(q[0], s))
    got = np.asarray(bitpal_packed.bitpal_packed(
        eq31, q, match=2, mismatch=-3, gap=-5, read_len=40, interpret=True))
    assert got.shape == (1, 100)


def test_banded_geometry_rejects_short_subjects():
    """_geometry's h < 0 check (subject shorter than query - k) fires on the
    XLA twin too, not just the stream wrappers' own messages."""
    from bgsa_tpu.ops import banded

    lo = np.zeros((5, 128), np.uint32)
    hi = np.zeros((5, 128), np.uint32)
    inj = np.zeros((5, 1, 128), np.uint32)
    with pytest.raises(ValueError, match="subject_len >= query_len"):
        banded.banded_xla(lo, hi, inj, np.zeros((1, 40), np.int32),
                          q_len=40, s_len=20, k=5)


@pytest.fixture
def awkward(rng):
    # 11 * 128 + 3 subjects: several blocks, the last one padded
    Q, m, S, n = 2, 40, 11 * 128 + 3, 37
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n))
    return q, s, m, n


def test_myers_padded_blocks(awkward):
    from bgsa_tpu.ops import myers_semiglobal

    q, s, m, n = awkward
    eq = pack.pack_eq(s, 32)
    got = np.asarray(myers_semiglobal.myers_semiglobal(
        eq, q, read_len=n, is_global=True, interpret=True))
    want = np.stack([-oracle.edit_distances(qi, s) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_semiglobal_padded_blocks(awkward):
    from bgsa_tpu.ops import myers_semiglobal

    q, s, m, n = awkward
    eq = pack.pack_eq(s, 32)
    got = np.asarray(
        myers_semiglobal.myers_semiglobal(eq, q, read_len=n, interpret=True)
    )
    want = np.stack(
        [-oracle.edit_distances(qi, s, Mode.SEMI_GLOBAL) for qi in q]
    )
    np.testing.assert_array_equal(got, want)


def test_bitpal_padded_blocks(awkward):
    from bgsa_tpu.ops import bitpal_packed

    q, s, m, n = awkward
    eq = pack.pack_eq(s, 31)
    kw = dict(match=2, mismatch=-3, gap=-5, read_len=n)
    want = np.stack([oracle.align_scores(qi, s, Scoring(2, -3, -5)) for qi in q])
    got = np.asarray(
        bitpal_packed.bitpal_packed(eq, q, interpret=True, **kw)
    )
    np.testing.assert_array_equal(got, want)


def test_banded_padded_blocks(rng):
    # the banded engine (banded_xla on every platform) at a subject count
    # that is not a multiple of the 128-subject pad unit
    from bgsa_tpu.banded_pipeline import BandedEngine
    from bgsa_tpu.banded_ref import banded_scores
    from bgsa_tpu.pipeline import PipelineConfig

    Q, m, S, n, k = 2, 64, 2 * (5 * 128 + 7), 70, 6
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n))
    s[: S // 3, :m] = q[0]
    got = np.asarray(BandedEngine(k, PipelineConfig()).scores(
        q, s.astype(np.uint8)))
    assert got.shape == (Q, S) and got.dtype == np.int8
    want = np.stack([banded_scores(qi, s, k) for qi in q])
    np.testing.assert_array_equal(got, want)


def _pallas_calls(fn, *specs):
    """Number of Pallas custom calls in fn's CUDA lowering."""
    text = jax.jit(fn).trace(*specs).lower(
        lowering_platforms=("cuda",)).as_text()
    return text.count("__gpu$xla.gpu.triton")


@pytest.mark.parametrize("n,kernel", [(150, 1), (3008, 1), (3009, 0)])
def test_myers_word_limit_routing(n, kernel):
    """Subjects up to MAX_WORDS words lower to one Triton kernel; longer
    ones route to the scan twin (no kernel at all)."""
    from bgsa_tpu.ops import myers_semiglobal as sg

    W = pack.word_count(n, 32)
    assert (W <= sg.MAX_WORDS) == bool(kernel)
    calls = _pallas_calls(
        lambda e, q: sg.myers_semiglobal(e, q, read_len=n, is_global=True),
        jax.ShapeDtypeStruct((5, W, 256), jnp.uint32),
        jax.ShapeDtypeStruct((2, 8), jnp.int32))
    assert calls == kernel


@pytest.mark.parametrize("n,kernel", [(500, 1), (1023, 1), (1024, 0)])
def test_bitpal_state_limit_routing(n, kernel):
    """Packed BitPAl takes the kernel while planes x words <= MAX_STATE
    (5 x 33 at (2,-3,-5)); larger states route to the XLA twin."""
    from bgsa_tpu.ops import bitpal_packed as bp

    W = pack.word_count(n, 31)
    calls = _pallas_calls(
        lambda e, q: bp.bitpal_packed(e, q, match=2, mismatch=-3, gap=-5,
                                      read_len=n),
        jax.ShapeDtypeStruct((5, W, 256), jnp.uint32),
        jax.ShapeDtypeStruct((2, 4), jnp.int32))
    assert calls == kernel


def test_kernel_route_decision():
    from bgsa_tpu.pipeline import kernel_route

    assert kernel_route("auto", platform="gpu") == "pallas"
    assert kernel_route("auto", platform="cuda") == "pallas"
    assert kernel_route("auto", platform="cpu") == "xla"
    assert kernel_route("auto", interpret=True, platform="cpu") == "pallas"
    assert kernel_route("xla", platform="gpu") == "xla"
    assert kernel_route("pallas", interpret=True, platform="cpu") == "pallas"
    with pytest.raises(ValueError, match="needs a GPU"):
        kernel_route("pallas", platform="cpu")
    # this suite runs on the CPU: the default decision is the XLA route
    assert kernel_route() == "xla"
