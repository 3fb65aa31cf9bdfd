"""The port's ``DeltaStreamPipeline`` (flat emission) against the JAX
package's pipeline and the NumPy spec, byte for byte (zero tolerance),
plus the slice's refusals and the no-silent-CPU rule."""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import make_frame_pair
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.models import DeltaStreamPipeline as JaxPipeline
from cudavideostream_tpu_torch.config import (
    CompactionBackend,
    StreamConfig,
    Visualizer,
)
from cudavideostream_tpu_torch.models import DeltaStreamPipeline
from cudavideostream_tpu_torch.models.pipeline import from_jax_state
from cudavideostream_tpu_torch.ops import reference_cpu
from cudavideostream_tpu_torch.utils import fonts

# stroke font at scale 4: 24-pixel cells, so a 64-pixel row fits two
# characters and a change in either shows in the payload
TEXTS = ["12", "13", "13", "13", "", "P5"]


def _port_config(jax_cfg):
    return StreamConfig(**{f.name: getattr(jax_cfg, f.name)
                           for f in dataclasses.fields(StreamConfig)
                           if f.name not in ("visualizer", "compaction")})


def _frames(cfg, rng, n=6):
    """n frames: a drifting scene with one exact repeat (frame 3 == 2)."""
    base, _ = make_frame_pair(rng, cfg.frame_bytes)
    frames = []
    for k in range(n):
        if k == 3:
            frames.append(frames[2].copy())
            continue
        frames.append(make_frame_pair(rng, cfg.frame_bytes)[1])
    return base, frames


def _assert_step_equal(port_out, jax_out):
    p_prev, p_pos, p_xs, p_vals, p_aux = port_out
    j_prev, j_pos, j_xs, j_vals, j_aux = jax_out
    assert p_aux is None and j_aux is None
    assert p_pos.dtype == torch.int32 and p_pos.dim() == 0
    assert int(p_pos) == int(j_pos)
    np.testing.assert_array_equal(p_xs.numpy(), np.asarray(j_xs))
    np.testing.assert_array_equal(p_vals.numpy(), np.asarray(j_vals))
    np.testing.assert_array_equal(p_prev.numpy(), np.asarray(j_prev))


@pytest.mark.parametrize("negfeed", [True, False], ids=["negfeed", "nofeed"])
def test_multi_frame_matches_jax(small_config, rng, negfeed):
    jcfg = dataclasses.replace(small_config, negative_feedback=negfeed)
    cfg = _port_config(jcfg)
    jpipe, pipe = JaxPipeline(jcfg), DeltaStreamPipeline(cfg, device="cpu")
    np.testing.assert_array_equal(pipe.atlas.numpy(), jpipe.atlas_np)
    base, frames = _frames(cfg, rng)
    jprev, prev = jpipe.init_state(base), pipe.init_state(base)
    positions = []
    for frame, text in zip(frames, TEXTS):
        jout = jpipe.step(jprev, frame, text=text)
        out = pipe.step(prev, frame, text=text)
        assert out[0] is prev  # the state is updated in place
        _assert_step_equal(out, jout)
        jprev, prev = jout[0], out[0]
        positions.append(int(out[1]))
    if negfeed:
        # an identical frame with identical text ships nothing
        assert positions[3] == 0
    assert positions[0] > 0


def test_from_jax_state_mid_stream(small_config, rng):
    """Start the port from the JAX pipeline's state after three frames
    (not from a base frame) and continue both in lockstep."""
    cfg = _port_config(small_config)
    jpipe = JaxPipeline(small_config)
    base, frames = _frames(cfg, rng)
    jprev = jpipe.init_state(base)
    for frame, text in zip(frames[:3], TEXTS[:3]):
        jprev = jpipe.step(jprev, frame, text=text)[0]
    prev, atlas = from_jax_state(np.asarray(jprev), jpipe.atlas_np,
                                 device="cpu")
    pipe = DeltaStreamPipeline(cfg, device="cpu", atlas=atlas)
    for frame, text in zip(frames[3:], TEXTS[3:]):
        jout = jpipe.step(jprev, frame, text=text)
        out = pipe.step(prev, frame, text=text)
        _assert_step_equal(out, jout)
        jprev, prev = jout[0], out[0]


def test_capacity_slices_payload_like_jax(small_config, rng):
    jcfg = dataclasses.replace(small_config, payload_capacity=500)
    cfg = _port_config(jcfg)
    jpipe, pipe = JaxPipeline(jcfg), DeltaStreamPipeline(cfg, device="cpu")
    base, frames = _frames(cfg, rng, n=2)
    jout = jpipe.step(jpipe.init_state(base), frames[0], text="12")
    out = pipe.step(pipe.init_state(base), frames[0], text="12")
    assert out[2].numel() == 500
    _assert_step_equal(out, jout)


def test_device_frame_skips_host_round_trip(small_config, rng):
    """A tensor frame is used where it lies; the result equals the numpy
    frame's."""
    cfg = _port_config(small_config)
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    base, frames = _frames(cfg, rng, n=1)
    a = pipe.step(pipe.init_state(base), frames[0], text="12")
    b = pipe.step(pipe.init_state(base), torch.from_numpy(frames[0]),
                  text="12")
    for x, y in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_1080p_step_matches_step_oracle():
    """One full-size step of the plain path against the NumPy spec (no
    JAX at this size)."""
    cfg = StreamConfig()
    rng = np.random.default_rng(1080)
    prev_np, cur = make_frame_pair(rng, cfg.frame_bytes)
    text = "FPS: 30 BW: 1234 kbps"
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    out = pipe.step(pipe.init_state(prev_np), cur, text=text)
    ids = fonts.encode_text(text)
    e_prev, e_pos, e_xs, e_vals, _ = reference_cpu.step_oracle(
        prev_np, cur, cfg, atlas=pipe.atlas_np, char_ids=ids)
    pos = int(out[1])
    assert pos == e_pos > 0
    np.testing.assert_array_equal(out[2][:pos].numpy(), e_xs)
    np.testing.assert_array_equal(out[3][:pos].numpy(), e_vals)
    assert not out[2][pos:].any() and not out[3][pos:].any()
    np.testing.assert_array_equal(out[0].numpy(), e_prev)


@pytest.mark.parametrize("change,item", [
    ({"visualizer": Visualizer.HEATMAP}, None),
    ({"noise_filter": True}, None),
    ({"compaction": CompactionBackend.SORT}, None),
    ({"compaction": CompactionBackend.HOST}, None),
    ({"tiled_payload": True, "emit_bitmask": True}, None),
    ({"tiled_payload": True, "emit_bitmask": True, "mask_payload": True},
     None),
    ({"tiled_payload": True, "emit_bitmask": True, "fetch_mode": "mask"},
     None),
    ({"tiled_payload": True, "emit_bitmask": True, "fetch_mode": "mask",
      "maskonly_payload": True}, None),
    ({"wire_format": "v4"}, None),
], ids=["visualizer", "noise_filter", "sort", "host", "bitmask",
        "mask_payload", "mask_fetch", "maskonly", "v4"])
def test_out_of_slice_configs_raise(small_config, change, item):
    """Configurations of slices not ported yet raise, naming the ROADMAP
    item that ports them; those of the mask slice (M8: the bitmask
    emissions, the mask landing and wire v4), of the visualizer slice
    (M10, M11: the filter bank and the noise filter) and the SORT and
    HOST backends (M12) are ported and build."""
    cfg = dataclasses.replace(_port_config(small_config), **change)
    if item is None:
        assert DeltaStreamPipeline(cfg, device="cpu").config is cfg
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        DeltaStreamPipeline(cfg, device="cpu")


@pytest.mark.parametrize("change", [
    {"tiled_payload": True},
    {"tiled_payload": True, "fetch_mode": "flat", "subtile_rows": 8},
    {"wire_format": "v2"},
    {"wire_format": "v3"},
], ids=["tiled", "tiled_flat", "v2", "v3"])
def test_tiled_slice_configs_build(small_config, change):
    """The tiled payload and wires v2/v3 are ported: their configs build."""
    cfg = dataclasses.replace(_port_config(small_config), **change)
    assert DeltaStreamPipeline(cfg, device="cpu").config is cfg


def test_threshold_map_raises(small_config):
    """The per-byte map is ported (ROADMAP M17): one of the frame's
    length builds, another length raises as the JAX pipeline does, and
    so does a tensor that is not uint8."""
    cfg = _port_config(small_config)
    tm = np.zeros(cfg.frame_bytes, np.uint8)
    pipe = DeltaStreamPipeline(cfg, device="cpu", threshold_map=tm)
    np.testing.assert_array_equal(pipe.threshold_map.numpy(), tm)
    with pytest.raises(ValueError, match="threshold_map"):
        DeltaStreamPipeline(cfg, device="cpu", threshold_map=tm[:-1])
    with pytest.raises(ValueError, match="threshold_map"):
        JaxPipeline(small_config, threshold_map=tm[:-1])
    with pytest.raises(ValueError, match="uint8"):
        DeltaStreamPipeline(cfg, device="cpu",
                            threshold_map=torch.zeros(cfg.frame_bytes))


def test_default_device_is_cuda_and_never_falls_back(small_config,
                                                     monkeypatch):
    """Without a card, the default device raises instead of running on
    the CPU; only an explicit device="cpu" runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_config(small_config)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeltaStreamPipeline(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_state(np.zeros(cfg.frame_bytes, np.uint8))
    assert DeltaStreamPipeline(cfg, device="cpu").device.type == "cpu"


def test_config_copy_matches_jax_config():
    """The port's config is a copy of the JAX package's: same fields,
    same defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(StreamConfig)}
    assert jf.keys() == pf.keys()
    for k in jf:
        a, b = jf[k], pf[k]
        if hasattr(a, "value"):  # enums of the two packages
            a, b = a.value, b.value
        assert a == b, k

