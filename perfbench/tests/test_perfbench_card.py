"""One short run of each cell through the benchmark's command
(`perfbench/run.py`) on a card; skips where there is none."""
import json
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card(cells):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (none here)")
    for name in cells:
        out = subprocess.run(
            [sys.executable, str(BENCH / "run.py"), "--workload", name,
             "--seed", "3000000777", "--seconds", "2", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-4000:]
        r = json.loads(out.stdout.strip().splitlines()[-1])
        assert r["correct"] is True, r["checks"]
        assert r["route"]["fallbacks"] == 0
        assert r["route"]["launches"] == r["route"]["launches_expected"]
