"""Local multi-device (--shards) coverage: banded shard_map path + the
sharded 2bit+sidecar transport (round-3 items; the reference's one-process-
drives-N-devices layer is ``banded/BGSA_KNC/cal_all.c:134-771``)."""

import jax
import numpy as np
import pytest

from bgsa_tpu import pack
from bgsa_tpu import pipeline as pl_mod
from bgsa_tpu.banded_pipeline import BandedEngine, run_banded
from bgsa_tpu.io import result as result_io
from bgsa_tpu.io import seqfile
from bgsa_tpu.schemes import Mode, Scoring, normalize


@pytest.fixture
def needs8():
    """Skip unless 8 devices are visible — decided when the test runs, not
    at import, so every test worker collects the same tests."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _rare_n_codes(rng, S, L, n_count=60):
    codes = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[rng.integers(0, S, n_count), rng.integers(0, L, n_count)] = 4
    return codes


def test_sidecar_pack_sharded_roundtrip(rng):
    """Per-shard position lists with local row indices reconstruct each
    shard's slice exactly (the shard_map contract)."""
    S, L, n_shards = 1024, 50, 4
    codes = _rare_n_codes(rng, S, L)
    pos = pack.sidecar_pack(codes, n_shards)
    assert pos.shape[0] % n_shards == 0
    k_pad = pos.shape[0] // n_shards
    per = S // n_shards
    clean = np.where(codes > 3, 0, codes).astype(np.uint8)
    packed = pack.two_bit_pack(clean)
    unpack = jax.jit(pack.transport_unpack_jax("2bitN"), static_argnums=1)
    for i in range(n_shards):
        sl = slice(i * per, (i + 1) * per)
        got = np.asarray(unpack((packed[sl], pos[i * k_pad : (i + 1) * k_pad]), L))
        np.testing.assert_array_equal(got, codes[sl])


def test_sidecar_pack_sharded_rejects_ragged():
    with pytest.raises(ValueError, match="not divisible"):
        pack.sidecar_pack(np.full((10, 8), 4, np.uint8), 4)


@pytest.mark.usefixtures("needs8")
def test_engine_sharded_sidecar_matches_single(rng):
    """An N-containing batch rides 2bitN under shard_map and scores equal to
    the single-device engine."""
    S, L = 2048, 40
    codes = _rare_n_codes(rng, S, L)
    assert pack.select_transport(codes, n_shards=4)[0] == "2bitN"
    q = rng.integers(0, 4, size=(3, 30)).astype(np.int32)
    scheme = normalize(Scoring(0, -1, -1), Mode.GLOBAL)
    single = pl_mod.Engine(scheme, pl_mod.PipelineConfig(backend="xla"))
    sharded = pl_mod.Engine(
        scheme, pl_mod.PipelineConfig(backend="xla", local_shards=4)
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.scores(q, codes)), np.asarray(single.scores(q, codes))
    )


@pytest.mark.usefixtures("needs8")
@pytest.mark.parametrize("s_len", [40, 27])  # s_len >= and < q_len geometries
def test_banded_engine_sharded_matches_single(rng, s_len):
    k, q_len = 4, 30
    q = rng.integers(0, 4, size=(3, q_len)).astype(np.int32)
    codes = rng.integers(0, 4, size=(512, s_len)).astype(np.uint8)
    single = BandedEngine(k, pl_mod.PipelineConfig(backend="xla"))
    sharded = BandedEngine(k, pl_mod.PipelineConfig(backend="xla", local_shards=4))
    assert sharded.n_shards == 4 and sharded.mesh is not None
    np.testing.assert_array_equal(
        np.asarray(sharded.scores(q, codes)), np.asarray(single.scores(q, codes))
    )


@pytest.mark.usefixtures("needs8")
def test_cli_banded_shards_byte_equal(tmp_path, rng):
    """`bgsa-align -k ... --shards 4` (previously a silent single-chip no-op)
    now computes on the mesh and byte-equals the single-device run."""
    from bgsa_tpu import cli

    q = rng.integers(0, 4, size=(3, 30))
    s = rng.integers(0, 4, size=(1024, 30))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    assert cli.main(["align", "-q", qp, "-d", sp, "-f", a, "-k", "4",
                     "--backend", "xla", "--quiet"]) == 0
    assert cli.main(["align", "-q", qp, "-d", sp, "-f", b, "-k", "4",
                     "--shards", "4", "--backend", "xla", "--quiet"]) == 0
    assert open(a, "rb").read() == open(b, "rb").read()
    assert open(a + ".info", "rb").read() == open(b + ".info", "rb").read()
    conv = str(tmp_path / "conv.txt")
    result_io.convert_result(b, conv, write_dtype=np.int8)
    # spot-check against the engine
    eng = BandedEngine(4, pl_mod.PipelineConfig(backend="xla"))
    want = np.asarray(eng.scores(q.astype(np.int32), s[:8].astype(np.uint8)))
    got = np.loadtxt(conv, dtype=np.int64).reshape(3, -1)
    np.testing.assert_array_equal(got[:, :8], want)


@pytest.mark.usefixtures("needs8")
def test_run_banded_sharded_pipeline(tmp_path, rng):
    """Full banded pipeline with local_shards: multi-bucket, lane pads."""
    q = rng.integers(0, 4, size=(2, 28))
    s = rng.integers(0, 4, size=(2100, 30))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    bucket = 1024 * 31
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    run_banded(qp, sp, a, 5,
               pl_mod.PipelineConfig(backend="xla", bucket_size=bucket))
    run_banded(qp, sp, b, 5,
               pl_mod.PipelineConfig(backend="xla", bucket_size=bucket,
                                     local_shards=4))
    # The lane-pad unit is v_num x shards, so the .info blocking (and hence
    # the raw bytes) differ; the converted text must be identical.
    ca, cb = str(tmp_path / "ca.txt"), str(tmp_path / "cb.txt")
    result_io.convert_result(a, ca, write_dtype=np.int8)
    result_io.convert_result(b, cb, write_dtype=np.int8)
    assert open(ca).read() == open(cb).read()


def test_shards_beyond_local_devices_rejected():
    """--shards N > visible devices must fail loudly: the mesh would truncate
    to the real device count while n_shards kept N, mis-placing the pre-split
    sidecar rows (silent score corruption; reference errors on a bad MIC
    count, original/BGSA_KNC/main.c:145-153)."""
    n = len(jax.devices()) + 1
    with pytest.raises(ValueError, match="exceeds"):
        pl_mod.Engine(normalize(Scoring(0, -1, -1), Mode.GLOBAL),
                      pl_mod.PipelineConfig(backend="xla", local_shards=n))
    with pytest.raises(ValueError, match="exceeds"):
        BandedEngine(4, pl_mod.PipelineConfig(backend="xla", local_shards=n))


@pytest.mark.usefixtures("needs8")
def test_shards_zero_uses_all_local_devices(rng):
    """local_shards=0 (CLI --shards 0) builds the mesh over every local
    device and scores byte-identically to single-device."""
    Q, m, S, n = 2, 18, 1024, 25
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n)).astype(np.uint8)
    scheme = normalize(Scoring(0, -1, -1), Mode.GLOBAL)
    all_dev = pl_mod.Engine(scheme, pl_mod.PipelineConfig(backend="xla", local_shards=0))
    assert all_dev.n_shards == len(jax.devices())
    single = pl_mod.Engine(scheme, pl_mod.PipelineConfig(backend="xla"))
    np.testing.assert_array_equal(
        np.asarray(all_dev.scores(q, s)), np.asarray(single.scores(q, s))
    )
