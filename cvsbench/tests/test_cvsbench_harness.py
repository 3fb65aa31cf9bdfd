"""A run of each cell on the CPU (the port's plain versions at the
harness's CPU size), the control and the faults that the comparison has
to catch, and the command's refusal without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cvsbench import check, control, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def small(cell_name, streams=None):
    """The cell with a short bank and few replays: the same path."""
    cell = harness.load_cell(cell_name)
    cell.traffic = dict(cell.traffic, bank_frames=4, warm_replays=1,
                        trace_replays=1)
    if streams:
        cell.traffic["streams"] = streams
    return cell


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cpu_run_is_correct(cell, traced):
    result, lines = harness.run(small(cell), 2**31 + 99, 0, traced, "cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert result["metrics"] == {}  # no device metric from the CPU
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(check.LIMITS)
    assert lines[-len(check.LIMITS):] == check.lines(
        {k: v["value"] for k, v in result["checks"].items()})
    assert result["attempted"] > 0


def _broken(monkeypatch, fault):
    orig = harness.Program.step

    def step(self, state, frames):
        saved = state.clone()
        pos, counts, xs_t, vals_t = orig(self, state, frames)
        b = self.streams
        if fault == "state unchanged":
            state.copy_(saved)
        elif fault == "half the batch left out":
            if b > 1:  # half of the streams
                state.view(b, -1)[b // 2:] = saved.view(b, -1)[b // 2:]
                pos[b // 2:] = 0
                counts[b // 2:] = 0
            else:  # half of the frame's bytes
                half = state.numel() // 2
                state[half:] = saved[half:]
        elif fault == "an answer altered":
            u = int(torch.nonzero(counts[0])[0])
            vals_t[0, u, 0] += 1
        return pos, counts, xs_t, vals_t

    monkeypatch.setattr(harness.Program, "step", step)


@pytest.mark.parametrize("fault", ["state unchanged",
                                   "half the batch left out",
                                   "an answer altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_come_out_not_correct(monkeypatch, cell, fault):
    _broken(monkeypatch, fault)
    cell = small(cell)
    result, _ = harness.run(cell, 12345, 0, False, "cpu")
    assert result["correct"] is False


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 3 * 10**9])
@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(cell, seed):
    c = small(cell)
    numbers = control.control(c, seed, "cpu")
    assert not check.verdict(numbers)
    # the reference in the program's place with its guarantee kept agrees
    assert check.verdict(control.control(c, seed, "cpu", feedback=True))


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "cvsbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.card
def test_cell_on_the_card():
    """One short run of the first cell on the card, at its own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = harness.run(harness.load_cell(CELLS[0]), 7, 1, False)
    assert result["correct"] is True
    assert result["metrics"]["fps"]["value"] > 0
