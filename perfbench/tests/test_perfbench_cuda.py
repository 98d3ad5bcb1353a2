"""On the card: the float8 control of each cell, put in the program's place,
comes out not correct at the cell's own size. Runs the benchmark's command
with ``--control 1`` (a short window: the check compares as many requests
as a run does), whose ``correct`` is decided by the control's first choices
through the same limits. Skips without a CUDA device.

    python -m pytest perfbench/tests/test_perfbench_cuda.py -m cuda -q
"""

import json
import subprocess
import sys

import pytest

import tiny

CELLS = [w["name"] for w in tiny.real_manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 4242, 2**32 + 17, 3 * 2**30 + 5])
def test_control_is_not_correct(cell, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    proc = subprocess.run(
        [sys.executable, str(tiny.HOME / "run.py"), "--workload", cell, "--seed",
         str(seed), "--seconds", "12", "--control", "1"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not line["correct"], line["checks"]
