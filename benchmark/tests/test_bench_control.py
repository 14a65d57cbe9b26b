"""The control of each cell on the card must come out not correct, and
the program as configured correct, at the cells' own sizes over a short
window: the control is the program with its TF32 matrix products on (the
precision below its float32 with TF32 off). Needs a CUDA card; run on the
machine that has one:

    python3 -m pytest benchmark/tests/test_bench_control.py -m cuda -q
"""

import json
import os
import subprocess
import sys

import pytest

import common


def _run(cell, seed, precision):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(common.BENCH / "run.py"), "--workload", cell,
                           "--seed", str(seed), "--seconds", "15", "--trace", "0",
                           "--precision", precision], cwd=common.ROOT, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["loc-gated", "loc-track", "odom-snake"])
def test_control_is_not_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is a precision of the card's matrix units")
    seed = 2**31 + 1234
    assert _run(cell, seed, "f32")["correct"] is True
    assert _run(cell, seed, "tf32")["correct"] is False
