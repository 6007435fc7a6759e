"""Card tests of the benchmark: one short run of every cell prints a result
line that keeps to the contract, and each cell's lower-precision control
(:data:`CONTROLS`) comes out not correct.  On a machine with a CUDA card:

    python -m pytest -q perfbench/tests/test_perfbench_card.py

They skip without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_prints_a_contract_line(card, workload):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload,
                          "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check" and line["correct"], line["check"]
    device = line["device"]
    assert device["platform"] == "gpu" and device["count"] == 1
    assert device["kind"] == torch.cuda.get_device_name(0)
    assert device["busy_s"] > 0 and device["window_s"] > 0
    assert len(line["breakdown"]["device_ops"]) <= 10
    for name, metric in line["metrics"].items():
        if name.endswith("roofline") or "mfu" in name:
            assert 0 < metric["value"] <= 100, (name, metric)
    assert out.stderr.strip().splitlines()[-1] == "check correct: True"


# Each cell's lower-precision control: TF32 products, except where the
# policy's net is a kernel of float32 FMAs that TF32 does not touch
# (SA-CADRL's value net), whose control is its weights rounded to bfloat16.
CONTROLS = {"cadrl4.serve16k": "bf16_weights"}


@pytest.mark.parametrize("workload", CELLS)
def test_the_cells_lower_precision_control_is_not_correct(card, workload):
    line = run.run_cell(workload, 2**31 + 9, 2.0, False, t_start=time.perf_counter(),
                        control=CONTROLS.get(workload, "tf32"))
    assert not line["correct"], line["check"]
