"""The fp8 control of each cell at its own size, on the card: the reference
with fp8 products in the program's place must come out not correct on
every seed tried."""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ["sd21base-train-paper", "sd21base-sample-eval", "sd15-train-paper"]
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(card, cell, seed):
    run = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", str(seed), "--seconds", "3", "--trace", "0",
                          "--control", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    print(cell, seed, json.dumps(line["limits"]))
    assert line["correct"] is False, line["limits"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [
    ("sd21base-train-paper", "half_batch"), ("sd15-train-paper", "half_batch")])
@pytest.mark.parametrize("seed", SEEDS)
def test_half_the_batch_is_not_correct(card, cell, fault, seed):
    """Half the batch in every step.  Half the batch in the step graph's
    capture and replays alone is held only by sd15's added rows, and not on
    every seed: the replayed step's gradient norms with half the batch can
    read like sound ones (PERF.md)."""
    run = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "tests",
                                                       "card_faults.py"), fault,
                          "--workload", cell, "--seed", str(seed), "--seconds", "3"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    print(cell, seed, fault, json.dumps(line["limits"]))
    assert line["correct"] is False, line["limits"]
