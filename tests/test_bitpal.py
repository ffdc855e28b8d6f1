import numpy as np
import pytest

from bgsa_tpu import pack
from bgsa_tpu.oracle import align_scores
from bgsa_tpu.ops import bitpal
from bgsa_tpu.schemes import Mode, Scoring

SCHEMES = [(2, -3, -5), (1, -1, -1), (3, -1, -2), (0, -2, -3), (5, -4, -11)]


def oracle(queries, subjects, M, I, G, mode=Mode.GLOBAL):
    return np.stack([align_scores(q, subjects, Scoring(M, I, G), mode) for q in queries])


@pytest.mark.parametrize("M,I,G", SCHEMES)
def test_xla_global_single_word(rng, M, I, G):
    q = rng.integers(0, 4, size=(2, 25)).astype(np.int32)
    s = rng.integers(0, 4, size=(8, 20))
    eq = pack.pack_eq(s, 31)
    got = np.asarray(
        bitpal.bitpal_xla(eq, q, match=M, mismatch=I, gap=G, read_len=20)
    )
    np.testing.assert_array_equal(got, oracle(q, s, M, I, G))


@pytest.mark.parametrize("n", [31, 32, 62, 70])
def test_xla_multi_word(rng, n):
    M, I, G = 2, -3, -5
    q = rng.integers(0, 4, size=(2, 40)).astype(np.int32)
    s = rng.integers(0, 4, size=(6, n))
    eq = pack.pack_eq(s, 31)
    got = np.asarray(bitpal.bitpal_xla(eq, q, match=M, mismatch=I, gap=G, read_len=n))
    np.testing.assert_array_equal(got, oracle(q, s, M, I, G), err_msg=f"n={n}")


def test_factor_scaling(rng):
    # (4,-6,-10) = 2 * (2,-3,-5): run reduced scheme with factor 2
    q = rng.integers(0, 4, size=(1, 30)).astype(np.int32)
    s = rng.integers(0, 4, size=(4, 35))
    eq = pack.pack_eq(s, 31)
    got = np.asarray(
        bitpal.bitpal_xla(eq, q, match=2, mismatch=-3, gap=-5, read_len=35, factor=2)
    )
    np.testing.assert_array_equal(got, oracle(q, s, 4, -6, -10))


def test_xla_semiglobal(rng):
    from bgsa_tpu.oracle import align_scores_query_in_subject

    M, I, G = 2, -3, -5
    q = rng.integers(0, 4, size=(2, 20)).astype(np.int32)
    s = rng.integers(0, 4, size=(6, 45))
    # plant exact query inside one subject: semi-global score = m*M
    s[0, 10:30] = q[0]
    eq = pack.pack_eq(s, 31)
    got = np.asarray(
        bitpal.bitpal_xla(eq, q, match=M, mismatch=I, gap=G, read_len=45, semi_global=True)
    )
    want = np.stack([align_scores_query_in_subject(qi, s, Scoring(M, I, G)) for qi in q])
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 20 * M


def test_pallas_matches_xla(rng):
    # the unpacked representation runs bitpal_xla on every route
    M, I, G = 2, -3, -5
    q = rng.integers(0, 4, size=(2, 30)).astype(np.int32)
    s = rng.integers(0, 4, size=(256, 40))
    eq = pack.pack_eq(s, 31)
    got = np.asarray(
        bitpal.bitpal_xla(eq, q, match=M, mismatch=I, gap=G, read_len=40)
    )
    np.testing.assert_array_equal(got, oracle(q, s, M, I, G))


def test_invalid_scheme():
    with pytest.raises(ValueError, match="M > I > 2G"):
        bitpal.BitpalParams(1, -4, -2)


def test_pallas_semiglobal_interpret(rng):
    """The packed kernel's semi-global score epilogue (interpret mode) and
    the unpacked route's (bitpal_xla), against the oracle."""
    from bgsa_tpu.oracle import align_scores_query_in_subject
    from bgsa_tpu.ops import bitpal_packed

    M, I, G = 2, -3, -5
    q = rng.integers(0, 4, size=(2, 20)).astype(np.int32)
    s = rng.integers(0, 4, size=(128, 45))
    s[0, 10:30] = q[0]
    want = np.stack(
        [align_scores_query_in_subject(qi, s, Scoring(M, I, G)) for qi in q]
    )
    kw = dict(match=M, mismatch=I, gap=G, read_len=45, semi_global=True)
    eq = pack.pack_eq(s, 31)
    np.testing.assert_array_equal(np.asarray(bitpal.bitpal_xla(eq, q, **kw)),
                                  want)
    np.testing.assert_array_equal(
        np.asarray(bitpal_packed.bitpal_packed(eq, q, interpret=True, **kw)),
        want)


@pytest.mark.parametrize("M,I,G", [(0, -1, -3), (1, 0, -2), (0, -1, -2)])
def test_adjacent_match_mismatch_schemes(rng, M, I, G):
    """M == I + 1 collapses the high-delta plane range (maxv == midv + 1),
    taking the trace-time network's degenerate else-branches for dv_not_hi /
    dh_lo_mask — a line-coverage sweep showed no other test ever built that
    network shape, in either representation."""
    from bgsa_tpu.ops import bitpal_packed

    q = rng.integers(0, 4, size=(2, 45)).astype(np.int32)
    s = rng.integers(0, 4, size=(256, 37))
    eq = pack.pack_eq(s, 31)
    want = oracle(q, s, M, I, G)
    kw = dict(match=M, mismatch=I, gap=G, read_len=37)
    np.testing.assert_array_equal(
        np.asarray(bitpal.bitpal_xla(eq, q, **kw)), want)
    params = bitpal.BitpalParams(M, I, G)
    assert bitpal_packed.packed_supported(params)
    np.testing.assert_array_equal(
        np.asarray(bitpal_packed.bitpal_packed_xla(eq, q, word_bits=31, **kw)),
        want)
    np.testing.assert_array_equal(
        np.asarray(bitpal_packed.bitpal_packed(eq, q, interpret=True, **kw)),
        want)


@pytest.mark.parametrize("M,I,G,n", [
    (2, -3, -5, 20), (2, -3, -5, 32), (2, -3, -5, 33), (2, -3, -5, 70),
    (1, -1, -1, 33), (3, -1, -2, 70), (0, -2, -3, 33),
    (9, -1, -2, 70),  # outside the packed decode's range: unpacked only
])
def test_unpacked_carry_variant_xla(rng, M, I, G, n):
    """The non-packed full-32-bit compare-carry variant (the generator's
    unpacked "carry" emission path, BitPAlGenerator.genKernel:39-64 x
    KNCArch isCarry): identical scores to the oracle at word-boundary-
    straddling lengths (32 fills exactly one full word; 33 forces the
    cross-word carry chain), including a scheme the packed decode cannot
    serve (M > 2I - 2G + 1)."""
    q = rng.integers(0, 4, size=(2, 45)).astype(np.int32)
    s = rng.integers(0, 4, size=(8, n))
    eq = pack.pack_eq(s, 32)
    got = np.asarray(
        bitpal.bitpal_xla(eq, q, match=M, mismatch=I, gap=G, read_len=n,
                          word_bits=32)
    )
    np.testing.assert_array_equal(got, oracle(q, s, M, I, G), err_msg=f"n={n}")


def test_unpacked_carry_semiglobal_factor_and_pallas(rng):
    from bgsa_tpu.oracle import align_scores_query_in_subject

    M, I, G = 2, -3, -5
    q = rng.integers(0, 4, size=(2, 20)).astype(np.int32)
    s = rng.integers(0, 4, size=(128, 45))
    s[0, 10:30] = q[0]
    eq = pack.pack_eq(s, 32)
    got = np.asarray(
        bitpal.bitpal_xla(eq, q, match=M, mismatch=I, gap=G, read_len=45,
                          word_bits=32, semi_global=True)
    )
    want = np.stack(
        [align_scores_query_in_subject(qi, s, Scoring(M, I, G)) for qi in q])
    np.testing.assert_array_equal(got, want)
    # factor multiply on the same words (the unpacked route is bitpal_xla)
    got2 = np.asarray(
        bitpal.bitpal_xla(eq, q, match=M, mismatch=I, gap=G, read_len=45,
                          word_bits=32, factor=2)
    )
    np.testing.assert_array_equal(got2, oracle(q, s, 2 * M, 2 * I, 2 * G))


def test_engine_unpacked_carry_matches_default(rng, tmp_path):
    """config.bitpal_carry with bitpal_packed=False routes the engine
    through the unpacked 32-bit kernel with byte-identical output — and a
    packed-ineligible scheme rides it too (word_bits routing no longer
    depends on the packed decode's range)."""
    from bgsa_tpu import pipeline as pl_mod
    from bgsa_tpu.io import seqfile
    from bgsa_tpu.schemes import Mode, normalize

    q = rng.integers(0, 4, size=(2, 40))
    s = rng.integers(0, 4, size=(300, 40))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    for scoring in (Scoring(2, -3, -5), Scoring(9, -1, -2)):
        scheme = normalize(scoring, Mode.GLOBAL)
        cfg = pl_mod.PipelineConfig(backend="xla", bitpal_packed=False,
                                    bitpal_carry=True)
        assert pl_mod.Engine(scheme, cfg).word_bits == 32
        # bitpal_carry=None auto-picks the layout per route: 32-bit
        # whenever the run lands on the unpacked network, 31-bit on the
        # packed one
        auto = pl_mod.PipelineConfig(backend="xla", bitpal_packed=False)
        assert auto.bitpal_carry is None
        assert pl_mod.Engine(scheme, auto).word_bits == 32
        force31 = pl_mod.PipelineConfig(backend="xla", bitpal_packed=False,
                                        bitpal_carry=False)
        assert pl_mod.Engine(scheme, force31).word_bits == 31
        a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
        pl_mod.run_alignment(qp, sp, a, scoring=scoring, config=force31)
        pl_mod.run_alignment(qp, sp, b, scoring=scoring, config=cfg)
        assert open(a, "rb").read() == open(b, "rb").read()
    # packed-eligible scheme on the packed route keeps the 31-bit layout
    scheme = normalize(Scoring(2, -3, -5), Mode.GLOBAL)
    assert pl_mod.Engine(
        scheme, pl_mod.PipelineConfig(backend="xla")).word_bits == 31
    # ...but auto goes 32-bit when the packed decode cannot serve the scheme
    assert pl_mod.Engine(
        normalize(Scoring(9, -1, -2), Mode.GLOBAL),
        pl_mod.PipelineConfig(backend="xla")).word_bits == 32
