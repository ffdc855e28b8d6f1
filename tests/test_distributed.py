"""`--host auto` against a real jax.distributed runtime (round-3 item).

The launcher workflow a pod user hits first: N processes each call
``jax.distributed.initialize(...)`` and run the same ``bgsa-align --host
auto`` command with *no* BGSA_HOST_ID in the environment — the role must
come from ``jax.process_index()/process_count()`` (cli._auto_host_role's
second branch). Runs on the CPU backend with a localhost coordinator.
"""

import os
import socket
import subprocess
import sys

import numpy as np

from bgsa_tpu import pipeline as pl_mod
from bgsa_tpu.io import result as result_io
from bgsa_tpu.io import seqfile
from bgsa_tpu.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROLE_SCRIPT = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
coord, pid = sys.argv[1], int(sys.argv[2])
jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                           process_id=pid)
assert jax.process_count() == 2, jax.process_count()
from bgsa_tpu import cli
sys.exit(cli.main(sys.argv[3:]))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_host_auto_from_jax_distributed(tmp_path, rng):
    Q, m, S, n = 3, 22, 700, 30
    q = rng.integers(0, 4, size=(Q, m))
    s = rng.integers(0, 4, size=(S, n))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)

    single = str(tmp_path / "single.bin")
    pl_mod.run_alignment(qp, sp, single, config=pl_mod.PipelineConfig(backend="xla"))
    conv_single = str(tmp_path / "single.txt")
    result_io.convert_result(single, conv_single)

    script = str(tmp_path / "role.py")
    with open(script, "w") as f:
        f.write(ROLE_SCRIPT)
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    env.pop("BGSA_HOST_ID", None)
    env.pop("BGSA_NUM_HOSTS", None)
    shards = [str(tmp_path / f"sh{h}.bin") for h in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, script, coord, str(h),
             "align", "-q", qp, "-d", sp, "-f", shards[h], "--host", "auto",
             "--backend", "xla", "--quiet"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for h in range(2)
    ]
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    metas = [multihost.ShardMeta.load(p + ".meta.json") for p in shards]
    assert [m.host_id for m in metas] == [0, 1] and metas[0].n_hosts == 2
    merged = str(tmp_path / "merged.bin")
    multihost.merge_shards(merged, shards, metas)
    conv_merged = str(tmp_path / "merged.txt")
    result_io.convert_result(merged, conv_merged)
    assert open(conv_merged).read() == open(conv_single).read()
    info = result_io.read_info(merged + ".info")
    assert info.device_num == 2
