"""bench.py measures the GPU or fails: no probe, no retry, no CPU fallback.

Every JSON line names the device it ran on; a run that finds no GPU exits
non-zero and prints no metric line, so a CPU number can never be recorded
under a device metric's name.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

sys.path.insert(0, REPO)
import bench  # noqa: E402


def test_bench_fails_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert not [l for l in r.stdout.splitlines() if l.strip().startswith("{")]
    assert "measures a GPU" in r.stderr


def test_bench_line_ids_cover_every_emitted_family():
    """Every line's family has a reference denominator, and each line
    carries its device."""
    assert bench.LINE_IDS == ("myers", "banded", "bitpal", "myers960")
    denoms = bench.family_denominators()
    assert set(denoms) >= {"myers", "bitpal", "banded"}
    assert all(v > 0 for v in denoms.values())


def test_bench_emit_names_the_device(capsys):
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    bench.emit("myers", "unit-cost Myers cal GCUPS", 1000.0, device)
    rec = json.loads(capsys.readouterr().out)
    assert rec["device"] == device
    assert rec["vs_baseline"] == 1000.0 / bench.BASELINES["myers"]
    assert set(rec) >= {"metric", "value", "unit", "vs_baseline", "line"}
