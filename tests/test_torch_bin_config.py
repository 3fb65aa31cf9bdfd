"""The binarize server build (``NOISE_VISUALIZER`` 5) as the benchmark
configures it (``cvsbench/configs/cvs_1080p_bin.json``): the benchmark's
own NumPy reference (``cvsbench/bin_reference.py``) against the port's
threshold and step on the CPU, the faults the comparison has to catch,
and the step's ``cvs.visualizer`` span."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cudavideostream_tpu_torch.models import DeltaStreamPipeline
from cudavideostream_tpu_torch.ops import filters
from cudavideostream_tpu_torch.utils import profiling
from cudavideostream_tpu_torch.utils.profiling import STEP
from cvsbench import bin_reference, check, harness, scene

ROOT = Path(__file__).resolve().parents[1]
CELL = "cvs_1080p_bin.cam1"
H, W = harness.CPU_HEIGHT, harness.CPU_WIDTH
STEPS = 8


def _ramp(up):
    h = np.arange(1, 257, dtype=np.int64) * 7
    return h if up else h[::-1].copy()


def _spike(i):
    h = np.zeros(256, np.int64)
    h[i] = 1000
    return h


def _two_peaks():
    h = np.full(256, 3, np.int64)
    h[40] = h[180] = 500
    return h


def _mode_at(i):
    h = np.full(256, 5, np.int64)
    h[i] = 900
    return h


CRAFTED = {
    "all in one bin": _spike(117),
    "all zero but bin 0": _spike(0),
    "two equal peaks": _two_peaks(),
    "monotone rise": _ramp(True),
    "monotone fall": _ramp(False),
    "mode at 0": _mode_at(0),
    "mode at 255": _mode_at(255),
    "empty": np.zeros(256, np.int64),
    "all bins equal": np.full(256, 9, np.int64),
}


def _random_hist(seed):
    """Seeded histograms of several kinds: broad, sparse with ties, and
    peaked (one gray frame's), so that ties and late maxima come up."""
    rng = np.random.default_rng(seed)
    kind = seed % 3
    if kind == 0:
        return rng.integers(0, 6, 256)
    if kind == 1:
        return rng.integers(0, 2, 256) * rng.integers(0, 4000, 256)
    g = np.clip(rng.normal(rng.integers(30, 226), rng.integers(3, 60),
                           4000), 0, 255).astype(np.int64)
    return np.bincount(g, minlength=256)


def _assert_same_threshold(h):
    ht = torch.from_numpy(np.asarray(h, np.int64)).to(torch.int32)
    imax, isec = filters.top2_prefix_max(ht)
    assert bin_reference.top2_scan(h) == (int(imax), int(isec))
    assert bin_reference.threshold(h) == int(filters.binarize_threshold(ht))


@pytest.mark.parametrize("name", list(CRAFTED))
def test_threshold_on_crafted_histograms(name):
    _assert_same_threshold(CRAFTED[name])


def test_threshold_crafted_values():
    # the later bin wins a tie; bin 0 alone leaves no runner-up, and the
    # clamp lifts T to 50; a rise, or no count at all, takes the last two
    # bins
    assert bin_reference.top2_scan(CRAFTED["two equal peaks"]) == (180, 40)
    assert bin_reference.threshold(CRAFTED["two equal peaks"]) == 110
    assert bin_reference.top2_scan(CRAFTED["all zero but bin 0"]) == (0, -1)
    assert bin_reference.threshold(CRAFTED["all zero but bin 0"]) == 50
    assert bin_reference.threshold(CRAFTED["monotone rise"]) == 200
    assert bin_reference.threshold(CRAFTED["monotone fall"]) == 50
    assert bin_reference.top2_scan(CRAFTED["empty"]) == (255, 254)


@pytest.mark.parametrize("seed", range(50))
def test_threshold_on_random_histograms(seed):
    _assert_same_threshold(_random_hist(seed))


def _cell_stream():
    cell = harness.load_cell(CELL)
    stream = dict(cell.config["stream"], height=H, width=W)
    return cell, stream


def test_configuration_names_this_reference():
    cell, stream = _cell_stream()
    # the NOISE_FILTER build with visualizer 5: the filter peaks the
    # scene's gray histogram, so that T follows each frame at 1080p
    base = json.loads((ROOT / "cvsbench/configs/cvs_1080p_denoise.json")
                      .read_text())
    assert cell.config["reference"] == "cvsbench.bin_reference"
    assert cell.config["stream"] == dict(base["stream"], visualizer=5)
    assert cell.config["stream"]["noise_filter"] is True
    assert cell.config["text"] == base["text"]
    assert cell.config["reduced"] == []
    assert cell.config["guarantees"][:4] == base["guarantees"]
    step = check.reference_step(cell.config, stream)
    assert type(step) is bin_reference.Step
    assert check.limits(stream) == dict(check.LIMITS,
                                        aux_frames_mismatched=0)
    with pytest.raises(ValueError, match="visualizer 5 only"):
        bin_reference.Step(dict(stream, visualizer=3), cell.config["text"])


# At the CPU size the status text's glyph cells cover most of the frame,
# so their black pixels fill gray bin 0 past any other bin and T is 50 on
# every frame; without text T follows each frame's own histogram. (At
# 1080p the filtered scene's top bin, about 48,000 pixels, outweighs the
# text's 23,358, and T follows the frame there too.)
TEXTS = {"status text": None, "no text": ""}


@pytest.mark.parametrize("text_case", list(TEXTS))
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_pipeline_equals_reference(seed, text_case):
    """The port's step at the harness's CPU size against the reference:
    payload, state and aux frame, byte for byte, step by step."""
    _check_pipeline_against_reference(seed, text_case, noise_filter=True)


@pytest.mark.parametrize("text_case", list(TEXTS))
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_unfiltered_pipeline_equals_reference(seed, text_case):
    """The same with the noise filter off: the reference's gray reads the
    overlaid frame alone."""
    _check_pipeline_against_reference(seed, text_case, noise_filter=False)


def _check_pipeline_against_reference(seed, text_case, noise_filter):
    cell, stream = _cell_stream()
    stream = dict(stream, noise_filter=noise_filter)
    text = TEXTS[text_case]
    text = cell.config["text"] if text is None else text
    traffic = dict(cell.traffic, bank_frames=STEPS)
    bank, base = scene.make_bank(traffic, H, W, seed, "cpu")
    pipe = DeltaStreamPipeline(harness.stream_config(stream), device="cpu")
    ref = bin_reference.Step(stream, text)
    prev = base[0].clone()
    state = base[0].numpy().copy()
    thresholds = set()
    for t in range(STEPS):
        raw = bank[t, 0].numpy()
        before = state.copy()
        _, pos, counts, xs_t, vals_t, aux = pipe.step(prev, bank[t, 0], text)
        cur = ref.frame_rows(raw, 0, H)
        xs, vals = ref.update(state, cur)
        keep = torch.arange(xs_t.shape[1]) < counts.to(torch.int64)[:, None]
        assert int(pos) == xs.size
        np.testing.assert_array_equal(xs_t[keep].numpy(), xs)
        np.testing.assert_array_equal(vals_t[keep].numpy(), vals)
        np.testing.assert_array_equal(prev.numpy(), state)
        ctx = ref.prepare(raw)
        thresholds.add(ctx)
        want = ref.aux_rows(cur, before, 0, H, ctx)
        assert aux.dtype == torch.uint8 and aux.numel() == H * W * 3
        np.testing.assert_array_equal(aux.numpy(), want)
        # the aux is the 255/0 image of the overlaid frame, both values
        # present
        assert set(np.unique(want)) == {0, 255}
    assert all(50 <= t <= 200 for t in thresholds)
    if text:
        assert thresholds == {50}
    else:
        assert len(thresholds) > 1


def _small_cell(text=None):
    """The cell with a short bank and few replays; ``text`` in place of
    the configuration's status text where given."""
    cell = harness.load_cell(CELL)
    cell.traffic = dict(cell.traffic, bank_frames=4, warm_replays=1,
                        trace_replays=1)
    if text is not None:
        cell.config = dict(cell.config, text=text)
    return cell


@pytest.mark.parametrize("text_case", list(TEXTS))
def test_harness_cell_is_correct(text_case):
    result, lines = harness.run(_small_cell(TEXTS[text_case]), 2**31 + 21,
                                0, False, "cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"]["aux_frames_mismatched"] == {"value": 0,
                                                         "limit": 0}
    assert lines[-1] == "check aux_frames_mismatched: 0 (limit 0)"


def _one_too_high(monkeypatch):
    orig = filters.binarize_threshold
    monkeypatch.setattr(filters, "binarize_threshold",
                        lambda h: orig(h) + 1)


def _fixed_at_50(monkeypatch):
    """T at its lower clamp whatever the histogram holds: what a K9 that
    skipped its histogram and scan would write."""
    monkeypatch.setattr(filters, "binarize_threshold",
                        lambda h: torch.tensor(50, dtype=torch.int32,
                                               device=h.device))


def _previous_frames(monkeypatch):
    """Each call gives the threshold of the call before it (the first
    call its own)."""
    orig = filters.binarize_threshold
    held = []

    def stale(h):
        t = orig(h)
        held.append(t)
        return held[-2] if len(held) > 1 else t

    monkeypatch.setattr(filters, "binarize_threshold", stale)


# a stale or fixed T is wrong only where T moves: at this size, without
# the status text
@pytest.mark.parametrize("fault,text_case", [
    (_one_too_high, "status text"), (_one_too_high, "no text"),
    (_previous_frames, "no text"), (_fixed_at_50, "no text")],
    ids=["T + 1", "T + 1, no text", "the previous frame's T, no text",
         "T fixed at 50, no text"])
def test_threshold_faults_come_out_not_correct(monkeypatch, fault,
                                               text_case):
    fault(monkeypatch)
    result, _ = harness.run(_small_cell(TEXTS[text_case]), 2**31 + 21, 0,
                            False, "cpu")
    assert result["correct"] is False
    assert result["checks"]["aux_frames_mismatched"]["value"] > 0
    # the payload and the states are untouched by the threshold
    assert all(result["checks"][k]["value"] == 0 for k in check.LIMITS)


def test_one_visualizer_span_a_step_inside_the_step():
    cell, stream = _cell_stream()
    text = cell.config["text"]
    bank, base = scene.make_bank(dict(cell.traffic, bank_frames=3), H, W,
                                 9, "cpu")
    pipe = DeltaStreamPipeline(harness.stream_config(stream), device="cpu")
    prev = base[0].clone()

    def steps():
        for t in range(3):
            pipe.step(prev, bank[t, 0], text)

    records, spans = profiling.trace_stages(steps, "cpu")
    assert records == []  # no device on the CPU
    outer = [s for s in spans if s[0] == STEP]
    vis = [s for s in spans if s[0] == "cvs.visualizer"]
    assert len(outer) == 3 and len(vis) == 3
    for o, v in zip(outer, vis):
        assert o[1] <= v[1] <= v[2] <= o[2]
