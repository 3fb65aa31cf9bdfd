"""The per-byte threshold-map serving path of the port (``--threshold-map``):
the pipeline step on every emission against the JAX pipeline built with
the same map and against ``step_oracle(threshold_map=)``, the red
visualizers' mask, a map of 0s and 255s without negative feedback, the
refusals, the handover from the JAX pipeline, and the server's flag over
a real socket to the port's and the JAX package's clients. Every
comparison is exact: these are integer byte streams."""

import dataclasses
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_frame_pair
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.config import Visualizer as JaxVisualizer
from cudavideostream_tpu.models import DeltaStreamPipeline as JaxPipeline
from cudavideostream_tpu.ops import diff as jax_diff
from cudavideostream_tpu.ops import reference_cpu as jax_ref
from cudavideostream_tpu.runtime.client import DeltaStreamClient as JaxClient
from cudavideostream_tpu_torch.config import StreamConfig, Visualizer
from cudavideostream_tpu_torch.models import DeltaStreamPipeline
from cudavideostream_tpu_torch.models.pipeline import from_jax_pipeline
from cudavideostream_tpu_torch.ops import diff as diff_ops
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.ops import reference_cpu
from cudavideostream_tpu_torch.runtime import server as server_mod
from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
from cudavideostream_tpu_torch.runtime.executor import (
    BatchedLandExecutor,
    ExecMetrics,
    PipelinedExecutor,
    StreamExecutor,
)
from cudavideostream_tpu_torch.runtime.sources import SyntheticSource
from cudavideostream_tpu_torch.utils import fonts

H, W = 48, 64
N = H * W * 3
EMISSIONS = {
    "flat": {},
    "tiled_sub1": dict(tiled_payload=True, subtile_rows=1),
    "tiled_sub0": dict(tiled_payload=True, subtile_rows=0),
    "tiled_bits": dict(tiled_payload=True, emit_bitmask=True),
    "maskonly": dict(tiled_payload=True, emit_bitmask=True,
                     fetch_mode="mask", maskonly_payload=True),
}


def port_config(jax_cfg) -> StreamConfig:
    """The port's copy of a JAX config (the enums map by value)."""
    kw = {f.name: getattr(jax_cfg, f.name)
          for f in dataclasses.fields(StreamConfig)
          if f.name not in ("visualizer", "compaction")}
    return StreamConfig(visualizer=Visualizer(jax_cfg.visualizer.value), **kw)


def door_map(rng, per_pixel=False):
    """60 over the scene, 4 in a "door" rectangle, a few 0s and 255s;
    per pixel ``(H, W)`` or per byte."""
    tm = np.full((H, W), 60, np.uint8)
    tm[12:36, 20:44] = 4
    tm[rng.integers(0, H, 20), rng.integers(0, W, 20)] = 0
    tm[rng.integers(0, H, 20), rng.integers(0, W, 20)] = 255
    return tm if per_pixel else np.repeat(tm.ravel(), 3)


def _stream(rng, n=4):
    base, _ = make_frame_pair(rng, N)
    frames = [make_frame_pair(rng, N, change_frac=0.2)[1] for _ in range(n)]
    frames[2] = frames[1].copy()  # an exact repeat
    return base, frames


def _lockstep(jcfg, tm, texts, rng):
    """Run the port's and the JAX pipeline with map ``tm`` over a stream:
    every output equal, and the payload, state and aux equal to
    ``step_oracle(threshold_map=tm)``."""
    cfg = port_config(jcfg)
    jpipe = JaxPipeline(jcfg, threshold_map=tm)
    pipe = DeltaStreamPipeline(cfg, device="cpu", threshold_map=tm)
    base, frames = _stream(rng, len(texts))
    jprev, prev = jpipe.init_state(base), pipe.init_state(base)
    e_prev = base
    shipped = []
    for frame, text in zip(frames, texts):
        ids = fonts.encode_text(text) if text else None
        e_prev, e_pos, e_xs, e_vals, e_aux = reference_cpu.step_oracle(
            e_prev, frame, cfg, pipe.atlas_np, ids, threshold_map=tm)
        jout = jpipe.step(jprev, frame, text=text)
        out = pipe.step(prev, frame, text=text)
        assert len(out) == len(jout)
        for a, b in zip(out, jout):
            if b is None:
                assert a is None
                continue
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), b)
        assert int(out[1]) == e_pos
        np.testing.assert_array_equal(out[0].numpy(), e_prev)
        if e_aux is not None:
            np.testing.assert_array_equal(out[-1].numpy(), e_aux)
        if not cfg.tiled_payload:
            np.testing.assert_array_equal(out[2].numpy()[:e_pos], e_xs)
            np.testing.assert_array_equal(out[3].numpy()[:e_pos], e_vals)
        shipped.append(e_pos)
        jprev, prev = jout[0], out[0]
    return shipped


@pytest.mark.parametrize("text", ["with_text", "no_text"])
@pytest.mark.parametrize("emission", list(EMISSIONS))
def test_map_step_matches_jax_and_oracle(emission, text, rng):
    """Every emission with a per-byte map: the port's step equals the JAX
    pipeline's (every block, the bits, counts and their dtype, new_prev)
    and step_oracle(threshold_map=), with and without overlay text."""
    jcfg = JaxConfig(height=H, width=W, overlay_scale=4, **EMISSIONS[emission])
    texts = ["12", "13", "13", "P5"] if text == "with_text" else [""] * 4
    tm = door_map(rng)
    shipped = _lockstep(jcfg, tm, texts, rng)
    assert shipped[2] == 0 < min(shipped[:2] + shipped[3:])  # the repeat
    # the map matters: the scalar threshold ships other bytes
    prev, cur = make_frame_pair(rng, N, change_frac=0.2)
    assert (reference_cpu.diff_encode(cur, prev, tm)[0]
            != reference_cpu.diff_encode(cur, prev, jcfg.threshold)[0])


@pytest.mark.parametrize("emission", ["flat", "maskonly"])
@pytest.mark.parametrize("vis", ["RED_BLACK", "RED_OVERLAP"])
def test_red_visualizers_read_the_map(vis, emission, rng):
    """Visualizers 2 and 3 mark the pixels the map ships, as the JAX
    pipeline and the spec do; the map holds 0s, so the JAX pipeline takes
    its diff_mask branch."""
    jcfg = JaxConfig(height=H, width=W, overlay_scale=4,
                     visualizer=JaxVisualizer[vis], **EMISSIONS[emission])
    _lockstep(jcfg, door_map(rng), ["12", "", "P5", "P5"], rng)


@pytest.mark.parametrize("emission", ["flat", "tiled_sub1", "maskonly"])
def test_map_of_0_and_255_without_negative_feedback(emission, rng):
    """A map of 0s (every change ships) and 255s (nothing ships), with
    negative feedback off (new_prev is the frame wherever it ships or
    not)."""
    jcfg = JaxConfig(height=H, width=W, overlay_scale=4,
                     negative_feedback=False, **EMISSIONS[emission])
    tm = np.where(rng.random(N) < 0.5, 0, 255).astype(np.uint8)
    shipped = _lockstep(jcfg, tm, ["12", "", "", "P5"], rng)
    assert shipped[2] == 0 < shipped[0]  # the repeat ships nothing


@pytest.mark.parametrize("length", [N - 1, N + 3, 1])
def test_wrong_length_map_raises(length):
    """A map of another length than the frame raises ValueError in the
    pipeline (as the JAX pipeline does) and in every kernel wrapper."""
    cfg = StreamConfig(height=H, width=W)
    tm = np.zeros(length, np.uint8)
    with pytest.raises(ValueError, match="threshold_map"):
        JaxPipeline(JaxConfig(height=H, width=W), threshold_map=tm)
    with pytest.raises(ValueError, match="threshold_map"):
        DeltaStreamPipeline(cfg, device="cpu", threshold_map=tm)
    cur = torch.zeros(N, dtype=torch.uint8)
    for fn in (logcompact.fused_diff_compact,
               logcompact.fused_diff_compact_tiled,
               logcompact.fused_diff_compact_mask,
               logcompact.segment_compact):
        with pytest.raises(ValueError, match="threshold_map"):
            fn(cur, cur.clone(), threshold_map=torch.from_numpy(tm))


def test_map_must_be_contiguous_uint8():
    cur = torch.zeros(N, dtype=torch.uint8)
    for bad in (torch.zeros(N, dtype=torch.int32),
                torch.zeros(2 * N, dtype=torch.uint8)[::2],
                np.zeros(N, np.uint8)):
        with pytest.raises(ValueError, match="threshold_map"):
            logcompact.fused_diff_compact(cur, cur.clone(), threshold_map=bad)


def test_diff_mask_reads_the_map_in_int16(rng):
    """|df| against a uint8 map: equal to the JAX diff_mask with the map,
    including |df| = 255 against 254 and 255 (no uint8 wrap)."""
    prev, cur = make_frame_pair(rng, N, change_frac=0.5)
    cur[:4], prev[:4] = 255, 0
    tm = rng.integers(0, 256, N, dtype=np.uint8)
    tm[:4] = [254, 255, 0, 128]
    got = diff_ops.diff_mask(torch.from_numpy(cur), torch.from_numpy(prev),
                             torch.from_numpy(tm))
    want = jax_diff.diff_mask(jnp.asarray(cur), jnp.asarray(prev),
                              jnp.asarray(tm))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0][:4].tolist() == [True, False, True, True]


def test_step_oracle_copy_matches_jax_with_a_map(rng):
    cfg = StreamConfig(height=H, width=W, overlay_scale=4,
                       visualizer=Visualizer.RED_OVERLAP)
    jcfg = JaxConfig(height=H, width=W, overlay_scale=4,
                     visualizer=JaxVisualizer.RED_OVERLAP)
    prev, cur = make_frame_pair(rng, N)
    tm = door_map(rng)
    atlas = fonts.make_atlas(cfg.overlay_scale, cfg.overlay_font)
    got = reference_cpu.step_oracle(prev, cur, cfg, atlas,
                                    fonts.encode_text("7"), threshold_map=tm)
    want = jax_ref.step_oracle(prev, cur, jcfg, atlas,
                               fonts.encode_text("7"), threshold_map=tm)
    assert got[1] == want[1]
    for a, b in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_array_equal(a, b)


def test_map_stays_on_the_pipeline_device(rng):
    """The map is held as a uint8 tensor (a tensor map is taken as it is)
    and as numpy, like the JAX pipeline's ``threshold_map_np``."""
    tm = door_map(rng)
    cfg = StreamConfig(height=H, width=W)
    pipe = DeltaStreamPipeline(cfg, device="cpu",
                               threshold_map=torch.from_numpy(tm))
    assert pipe.threshold_map.dtype == torch.uint8
    assert pipe.threshold_map.device.type == "cpu"
    np.testing.assert_array_equal(pipe.threshold_map_np, tm)
    assert DeltaStreamPipeline(cfg, device="cpu").threshold_map is None


def test_from_jax_pipeline_carries_the_map(rng):
    """A mid-stream handover from a JAX pipeline built with a map: the
    port takes the map with the state and goes on in lockstep."""
    jcfg = JaxConfig(height=H, width=W, overlay_scale=4, tiled_payload=True)
    tm = door_map(rng)
    jpipe = JaxPipeline(jcfg, threshold_map=tm)
    base, frames = _stream(rng)
    jprev = jpipe.init_state(base)
    for frame in frames[:2]:
        jprev = jpipe.step(jprev, frame, text="12")[0]
    pipe, prev = from_jax_pipeline(port_config(jcfg), np.asarray(jprev),
                                   jpipe.atlas_np, jpipe.conv_weights_q16,
                                   device="cpu",
                                   threshold_map=jpipe.threshold_map_np)
    np.testing.assert_array_equal(pipe.threshold_map_np,
                                  jpipe.threshold_map_np)
    for frame in frames[2:]:
        jout = jpipe.step(jprev, frame, text="13")
        out = pipe.step(prev, frame, text="13")
        for a, b in zip(out, jout):
            if b is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jprev, prev = jout[0], out[0]


@pytest.mark.parametrize("flags,cls", [
    ([], StreamExecutor),
    (["--tiled", "--pipelined", "--wire", "v3"], PipelinedExecutor),
    (["--tiled", "--land-batch", "2"], BatchedLandExecutor),
], ids=["stream", "pipelined", "land_batch"])
def test_server_flag_builds_each_executor_on_the_map(flags, cls, tmp_path,
                                                     rng):
    """``--threshold-map`` reaches the pipeline of every executor the
    server builds; a 2-D map is per pixel (x3 to bytes)."""
    path = str(tmp_path / "map.npy")
    np.save(path, door_map(rng, per_pixel=True))
    cfg, ex, _, args = server_mod.setup(
        ["--device", "cpu", "--height", str(H), "--width", str(W),
         "--threshold-map", path] + flags)
    assert type(ex) is cls and args.threshold_map == path
    np.testing.assert_array_equal(
        ex.pipe.threshold_map_np,
        np.repeat(np.load(path).ravel(), 3))
    _, ex, _, _ = server_mod.setup(["--device", "cpu", "--height", str(H),
                                    "--width", str(W)] + flags)
    assert ex.pipe.threshold_map is None


def test_load_threshold_map_matches_the_jax_server(tmp_path, rng):
    """A 2-D map repeats per pixel; any other shape is read per byte."""
    for shape in ((H, W), (N,), (H, W, 3)):
        a = rng.integers(0, 256, shape).astype(np.int64)
        path = str(tmp_path / "m.npy")
        np.save(path, a)
        want = np.repeat(a.ravel(), 3) if a.ndim == 2 else a.ravel()
        got = server_mod.load_threshold_map(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want.astype(np.uint8))


LOOPBACKS = {
    "pixel_map_flat": (True, []),
    "byte_map_maskonly_v4_batch2": (
        False, ["--tiled", "--fetch", "mask", "--maskonly", "--wire", "v4",
                "--land-batch", "2"]),
}


@pytest.mark.parametrize("client_kind", ["port", "jax"])
@pytest.mark.parametrize("path", list(LOOPBACKS))
def test_server_main_threshold_map_loopback(path, client_kind, tmp_path,
                                            monkeypatch, rng):
    """The server's ``main(argv)`` with ``--threshold-map`` (a per-pixel
    and a per-byte ``.npy``) over a real socket, decoded by the port's and
    the JAX package's clients: each reconstruction equals a replay of the
    source through ``step_oracle(threshold_map=)`` from its second frame
    (the server starts its executor on the first, as the JAX server
    does), every frame. The 1 Hz
    status text is held off so that the replay knows the overlay."""
    per_pixel, flags = LOOPBACKS[path]
    tm = door_map(rng, per_pixel=per_pixel)
    map_path = str(tmp_path / "map.npy")
    np.save(map_path, tm)
    monkeypatch.setattr(ExecMetrics, "status_line", lambda self, r: None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n_frames = 5
    args = ["--height", str(H), "--width", str(W), "--frames", str(n_frames),
            "--port", str(port), "--device", "cpu", "--seed", "7",
            "--threshold-map", map_path] + flags
    errors = []

    def run():
        try:
            server_mod.main(args)
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    cls = (DeltaStreamClient if client_kind == "port"
           else lambda *a: JaxClient(*a, wire_format="auto"))
    for _ in range(200):  # until the server listens
        cli = cls("127.0.0.1", port, H, W)
        try:
            cli.connect()
            break
        except ConnectionRefusedError:
            threading.Event().wait(0.05)
    cfg = StreamConfig(height=H, width=W)
    replay = SyntheticSource(cfg, seed=7)
    replay.base_frame()  # the frame the server's executor started on
    prev = replay.base_frame()
    np.testing.assert_array_equal(cli.frame, prev)
    tm_bytes = np.repeat(tm.ravel(), 3) if per_pixel else tm
    positions = []
    for _ in range(n_frames):
        pos, recon = cli.read_frame()
        prev, e_pos = reference_cpu.step_oracle(
            prev, next(replay), cfg, threshold_map=tm_bytes)[:2]
        assert pos == e_pos
        np.testing.assert_array_equal(recon, prev)
        positions.append(pos)
    cli.close()
    t.join(timeout=30)
    assert not t.is_alive() and not errors
    assert max(positions) > 0
