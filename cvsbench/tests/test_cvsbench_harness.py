"""A run of each cell on the CPU (the port's plain versions at the
harness's CPU size), the control and the faults that the comparison has
to catch, the side outputs (a visualizer's aux frame, judged by a
reference the configuration names, and the change bits), and the
command's refusal without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cvsbench import check, control, harness, reference

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
# the cells whose configurations name no reference and have no side
# output, and the numbers they have always been judged by
PLAIN_CELLS = ["cvs_1080p.cam1", "cvs_1080p_denoise.cam1", "cvs_1080p.cam4"]
PLAIN_CHECKS = ["start_state_bytes", "entry_state_bytes",
                "frames_mismatched", "final_state_bytes"]
RED_OVERLAP = "cvsbench.tests.red_overlap_reference"


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
    c = small(cell)
    stream = c.config["stream"]
    result, lines = harness.run(c, 2**31 + 99, 0, traced, "cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert result["metrics"] == {}  # no device metric from the CPU
    assert list(result)[-1] == "checks"
    limits = check.limits(stream)
    assert set(result["checks"]) == set(limits)
    assert lines[-len(limits):] == check.lines(
        {k: v["value"] for k, v in result["checks"].items()}, stream)
    assert result["attempted"] > 0


@pytest.mark.parametrize("cell", PLAIN_CELLS)
def test_no_reference_keeps_the_checks(cell):
    c = small(cell)
    assert "reference" not in c.config
    result, lines = harness.run(c, 2**31 + 98, 0, False, "cpu")
    assert list(result["checks"]) == PLAIN_CHECKS
    assert [ln.split(":")[0] for ln in lines[-4:]] == [
        f"check {k}" for k in PLAIN_CHECKS]


def with_stream(cell, reference=None, **stream):
    """``cell`` with keys of its configuration's ``stream`` block changed
    and, where given, the reference it names."""
    config = dict(cell.config, stream=dict(cell.config["stream"], **stream))
    if reference:
        config["reference"] = reference
    cell.config = config
    return cell


def vis_cell(streams=1):
    """The default cell with visualizer 3, judged by the test's NumPy
    reference of it."""
    return with_stream(small("cvs_1080p.cam1", streams), RED_OVERLAP,
                       visualizer=3)


def bits_cell():
    return with_stream(small("cvs_1080p.cam1"), emit_bitmask=True)


def _broken(monkeypatch, fault):
    orig = harness.Program.step
    held = {}

    def step(self, state, frames):
        saved = state.clone()
        pos, counts, xs_t, vals_t, side = orig(self, state, frames)
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
        elif fault == "an aux byte altered":
            side["aux"][0, 7] += 1
        elif fault == "the previous step's aux":
            side["aux"], held["aux"] = held.get("aux", side["aux"]), \
                side["aux"]
        elif fault == "the aux zeroed":
            side["aux"].zero_()
        elif fault == "the streams' aux swapped":
            side["aux"] = side["aux"].flip(0)
        elif fault == "a bit flipped":
            side["bits"][0, 3] ^= 4
        return pos, counts, xs_t, vals_t, side

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
    stream = c.config["stream"]
    numbers = control.control(c, seed, "cpu")
    assert not check.verdict(numbers, stream)
    # the reference in the program's place with its guarantee kept agrees
    assert check.verdict(control.control(c, seed, "cpu", feedback=True),
                         stream)


@pytest.mark.parametrize("streams", [1, 2])
def test_visualizer_cell_is_correct(streams):
    c = vis_cell(streams)
    result, lines = harness.run(c, 2**31 + 7, 0, False, "cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"]["aux_frames_mismatched"] == {"value": 0,
                                                         "limit": 0}
    assert list(result["checks"]) == PLAIN_CHECKS + ["aux_frames_mismatched"]
    assert lines[-1] == "check aux_frames_mismatched: 0 (limit 0)"


def test_bits_cell_is_correct():
    result, _ = harness.run(bits_cell(), 2**31 + 8, 0, False, "cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert list(result["checks"]) == PLAIN_CHECKS + ["bits_frames_mismatched"]
    assert result["checks"]["bits_frames_mismatched"]["value"] == 0


@pytest.mark.parametrize("fault,streams", [
    ("an aux byte altered", 1), ("an aux byte altered", 2),
    ("the previous step's aux", 1), ("the previous step's aux", 2),
    ("the aux zeroed", 1), ("the aux zeroed", 2),
    ("the streams' aux swapped", 2),
    ("a bit flipped", 1),
])
def test_side_output_faults_come_out_not_correct(monkeypatch, fault,
                                                 streams):
    _broken(monkeypatch, fault)
    c = bits_cell() if fault == "a bit flipped" else vis_cell(streams)
    result, _ = harness.run(c, 54321, 0, False, "cpu")
    assert result["correct"] is False and result["failed"] > 0
    side = "bits" if fault == "a bit flipped" else "aux"
    assert result["checks"][f"{side}_frames_mismatched"]["value"] > 0
    # the payload and the states are the program's own, and right
    assert all(result["checks"][k]["value"] == 0 for k in PLAIN_CHECKS)


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
@pytest.mark.parametrize("case", ["aux", "aux, 2 streams", "bits"])
def test_control_with_side_outputs(case, seed):
    c = bits_cell() if case == "bits" else vis_cell(
        2 if "2 streams" in case else 1)
    stream = c.config["stream"]
    assert not check.verdict(control.control(c, seed, "cpu"), stream)
    kept = control.control(c, seed, "cpu", feedback=True)
    assert check.verdict(kept, stream)
    assert set(kept) >= set(check.limits(stream))


@pytest.mark.parametrize("case,match", [
    ("maskonly", "mask-only"),
    ("bits, 2 streams", "no change bits"),
])
def test_program_refuses(case, match):
    if case == "maskonly":
        c = with_stream(small("cvs_1080p.cam1"), emit_bitmask=True,
                        maskonly_payload=True, fetch_mode="mask")
    else:
        c = with_stream(small("cvs_1080p.cam1", 2), emit_bitmask=True)
    with pytest.raises(ValueError, match=match):
        harness.run(c, 1, 0, False, "cpu")


@pytest.mark.parametrize("reference,match", [
    (None, "does not work out aux"),
    ("cudavideostream_tpu_torch.models", "a module under cvsbench"),
])
def test_reference_refused(reference, match):
    c = vis_cell()
    config = dict(c.config, reference=reference)
    if reference is None:
        del config["reference"]
    with pytest.raises(ValueError, match=match):
        check.reference_step(config, config["stream"])


def test_reference_found_by_name():
    c = vis_cell()
    from cvsbench.tests import red_overlap_reference

    step = check.reference_step(c.config, c.config["stream"])
    assert type(step) is red_overlap_reference.Step
    plain = small("cvs_1080p.cam1").config
    assert type(check.reference_step(plain, plain["stream"])) is \
        reference.Step


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
