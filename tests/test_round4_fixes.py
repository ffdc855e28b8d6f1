"""Round-4 regression tests.

1) Long-subject envelope: the reference kernels take any word_num
   (original/BGSA_SSE/cal_sse.c:253-257, chunk_read_num >= 1 at any
   max_length), but a kernel keeps its bit-vector state in registers, so
   past a measured per-family word count (myers_semiglobal.MAX_WORDS,
   bitpal_packed.MAX_STATE) the wrappers route to their XLA twin (any
   length, same scores).
"""

import numpy as np
import pytest

from bgsa_tpu import pack
from bgsa_tpu.oracle import edit_distances
from bgsa_tpu.ops import bitpal, bitpal_packed, blockutil, myers_semiglobal


def test_vmem_floor_logic():
    # the word-count limits, as measured on the card: Myers to 3000 bp
    # (94 full words), packed BitPAl (2,-3,-5) to 1000 bp (5 planes x 33)
    assert myers_semiglobal.MAX_WORDS == pack.word_count(3000, 32) == 94
    p = bitpal.BitpalParams(2, -3, -5)
    nbits = bitpal_packed._bits_num(p)
    assert nbits * pack.word_count(1000, 31) == bitpal_packed.MAX_STATE
    assert nbits * pack.word_count(1024, 31) > bitpal_packed.MAX_STATE


def _long_subjects(rng, count, length):
    return rng.integers(0, 4, size=(count, length))


def test_myers_fullword_12kbp_routes_to_xla(rng):
    # 12288 bp -> W=384 full words > MAX_WORDS: the call must succeed on
    # ANY backend (here CPU, where a non-interpret pallas_call cannot run
    # at all) and match the oracle.
    n = 12288
    q = rng.integers(0, 4, size=(1, 24)).astype(np.int32)
    s = _long_subjects(rng, 1024, n)
    eq = pack.pack_eq(s, 32)
    got = np.asarray(
        myers_semiglobal.myers_semiglobal(eq, q, read_len=n, factor=-1, is_global=True)
    )
    want = -edit_distances(q[0], s[:8])
    np.testing.assert_array_equal(got[0, :8], want)


def test_myers_31bit_12kbp_routes_to_xla(rng):
    # the XLA route's 31-bit reserved-carry twin takes any length
    from bgsa_tpu.ops import myers_xla

    n = 12400  # W = ceil(12400/31) = 400 words
    q = rng.integers(0, 4, size=(1, 16)).astype(np.int32)
    s = _long_subjects(rng, 1024, n)
    eq = pack.pack_eq(s, 31)
    got = np.asarray(myers_xla.myers_global(eq, q, read_len=n, factor=-1))
    want = -edit_distances(q[0], s[:8])
    np.testing.assert_array_equal(got[0, :8], want)


def test_bitpal_packed_long_routes_to_xla(rng, monkeypatch):
    # (2,-3,-5): 5 planes x W words -> routes past W = 33 (~1 kbp).
    # The BitPAl twins keep Python word loops (their plane networks make a
    # word scan a much bigger rewrite), whose compile at W=300 costs minutes
    # — so this asserts the ROUTING via a recorder; the routed math itself
    # is the twin the rest of the suite already diffs against the compiled
    # reference, and the Myers 12 kbp tests above run their routed path
    # end-to-end.
    n = 9300  # W = 300
    q = rng.integers(0, 4, size=(1, 12)).astype(np.int32)
    s = _long_subjects(rng, 1024, n)
    eq = pack.pack_eq(s, 31)
    calls = []
    monkeypatch.setattr(
        bitpal_packed, "bitpal_packed_xla",
        lambda *a, **kw: calls.append((a, kw)) or np.zeros((1, s.shape[0]), np.int32),
    )
    bitpal_packed.bitpal_packed(
        eq, q, match=2, mismatch=-3, gap=-5, read_len=n, factor=1
    )
    assert len(calls) == 1
    assert calls[0][1]["read_len"] == n and calls[0][1]["match"] == 2


def test_bitpal_nonpacked_long_routes_to_xla(rng, monkeypatch):
    # The unpacked representation has no kernel: (1,-2,-3) holds 7 planes
    # per word, so the engine's kernel route runs bitpal_xla at any length.
    import jax.numpy as jnp

    from bgsa_tpu.pipeline import Engine, PipelineConfig
    from bgsa_tpu.schemes import Scoring, normalize

    n = 40
    q = rng.integers(0, 4, size=(1, 10)).astype(np.int32)
    s = _long_subjects(rng, 128, n).astype(np.uint8)
    calls = []
    monkeypatch.setattr(
        bitpal, "bitpal_xla",
        lambda *a, **kw: calls.append((a, kw)) or jnp.zeros((1, s.shape[0]), jnp.int32),
    )
    eng = Engine(normalize(Scoring(1, -2, -3)),
                 PipelineConfig(backend="pallas", interpret=True,
                                bitpal_packed=False))
    assert eng.backend == "pallas"
    eng.scores(q, s)
    assert len(calls) == 1
    assert calls[0][1]["gap"] == -3 and calls[0][1]["read_len"] == n


@pytest.mark.parametrize("is_global", [True, False])
def test_xla_word_scan_matches_word_loop(rng, is_global):
    """The W > 64 word-scan variants of the XLA twins are bit-identical to
    the unrolled word loop across the dispatch boundary (65 words straddled
    against the oracle; the loop variant is oracle-checked suite-wide)."""
    from bgsa_tpu.oracle import Mode

    n = 65 * 32  # W = 65 full words -> scan path
    q = rng.integers(0, 4, size=(2, 21)).astype(np.int32)
    s = _long_subjects(rng, 128, n)
    eq = pack.pack_eq(s, 32)
    got = np.asarray(myers_semiglobal.myers_semiglobal_xla(
        eq, q, read_len=n, factor=-1, is_global=is_global))
    mode = Mode.GLOBAL if is_global else Mode.SEMI_GLOBAL
    want = np.stack([-edit_distances(qi, s, mode) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_xla_31bit_word_scan_matches_oracle(rng):
    from bgsa_tpu.ops import myers_xla

    n = 65 * 31  # W = 65 -> scan path
    q = rng.integers(0, 4, size=(2, 17)).astype(np.int32)
    s = _long_subjects(rng, 128, n)
    eq = pack.pack_eq(s, 31)
    got = np.asarray(myers_xla.myers_global(eq, q, read_len=n, factor=-1))
    want = np.stack([-edit_distances(qi, s) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_mid_envelope_stays_on_pallas(rng, monkeypatch):
    """3 kbp (W=94, the measured limit) must NOT be demoted to the XLA twin.
    Recorder check: running the real W=94 kernel through the XLA-CPU
    compiler takes minutes, so the twin is patched to fail loud and
    pallas_call to a recorder returning the right shape."""
    n = 94 * 32
    q = rng.integers(0, 4, size=(1, 6)).astype(np.int32)
    s = _long_subjects(rng, 1024, n)
    eq = pack.pack_eq(s, 32)

    def no_route(*a, **kw):
        raise AssertionError("mid-envelope geometry was routed to the XLA twin")

    monkeypatch.setattr(myers_semiglobal, "myers_semiglobal_xla", no_route)
    pallas_calls = []
    real_pallas_call = blockutil.pl.pallas_call

    def fake_pallas_call(kernel, **kw):
        pallas_calls.append(kw["out_shape"].shape)
        return lambda *args: np.zeros(kw["out_shape"].shape, np.int32)

    monkeypatch.setattr(blockutil.pl, "pallas_call", fake_pallas_call)
    try:
        out = myers_semiglobal.myers_semiglobal(
            eq, q, read_len=n, factor=-1, is_global=True
        )
    finally:
        monkeypatch.setattr(blockutil.pl, "pallas_call", real_pallas_call)
    assert len(pallas_calls) == 1
    assert out.shape == (1, s.shape[0])


def test_short_subjects_still_use_pallas_path(rng):
    # A healthy geometry must not be re-routed: interpret=True only works on
    # the pallas_call path, so reaching it proves the guard stayed off.
    q = rng.integers(0, 4, size=(1, 12)).astype(np.int32)
    s = _long_subjects(rng, 256, 64)
    eq = pack.pack_eq(s, 32)
    got = np.asarray(
        myers_semiglobal.myers_semiglobal(
            eq, q, read_len=64, factor=-1, is_global=True, interpret=True
        )
    )
    want = -edit_distances(q[0], s)
    np.testing.assert_array_equal(got[0], want)
