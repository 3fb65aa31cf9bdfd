"""The visualizer and noise-filter serving path of the port: the aux frame
on the tiled, bitmask and bitmask-only emissions against the JAX
pipeline, its landing by every executor against the JAX executor and the
NumPy spec, the ``--aux-dir`` dump over a real socket against the JAX
package's ``write_ppm``, and the server's new flags."""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from conftest import ScriptedSource, make_frame_pair
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.config import Visualizer as JaxVisualizer
from cudavideostream_tpu.models import DeltaStreamPipeline as JaxPipeline
from cudavideostream_tpu.runtime.client import write_ppm as jax_write_ppm
from cudavideostream_tpu.runtime.executor import StreamExecutor as JaxExecutor
from cudavideostream_tpu_torch.config import (
    PayloadOverflowError,
    StreamConfig,
    Visualizer,
)
from cudavideostream_tpu_torch.models import DeltaStreamPipeline
from cudavideostream_tpu_torch.ops import hist
from cudavideostream_tpu_torch.ops import reference_cpu
from cudavideostream_tpu_torch.runtime import server as server_mod
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.client import (
    DeltaStreamClient,
    write_ppm,
)
from cudavideostream_tpu_torch.runtime.executor import (
    BatchedLandExecutor,
    PipelinedExecutor,
    StreamExecutor,
)
from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer
from cudavideostream_tpu_torch.utils import fonts

EMISSIONS = {
    "tiled": dict(tiled_payload=True),
    "bitmask": dict(tiled_payload=True, emit_bitmask=True),
    "maskonly": dict(tiled_payload=True, emit_bitmask=True,
                     fetch_mode="mask", maskonly_payload=True),
}
TEXTS = ["12", "13", "", "P5"]


def port_config(jax_cfg) -> StreamConfig:
    """The port's copy of a JAX config; the two packages' enums differ,
    so the visualizer is mapped by value."""
    kw = {f.name: getattr(jax_cfg, f.name)
          for f in dataclasses.fields(StreamConfig)
          if f.name not in ("visualizer", "compaction")}
    return StreamConfig(visualizer=Visualizer(jax_cfg.visualizer.value), **kw)


def _jax_config(**kw):
    return JaxConfig(height=48, width=64, overlay_scale=4, **kw)


def _stream(cfg, rng, n=4):
    base, _ = make_frame_pair(rng, cfg.frame_bytes)
    return base, [make_frame_pair(rng, cfg.frame_bytes)[1] for _ in range(n)]


@pytest.mark.parametrize("vis", ["BINARIZE", "RED_OVERLAP"])
@pytest.mark.parametrize("emission", list(EMISSIONS))
def test_visualizer_on_tiled_emissions_matches_jax(emission, vis, rng):
    """Binarize and red-overlap on the tiled, bitmask and bitmask-only
    emissions: every block, the bits and the aux frame equal the JAX
    pipeline's, over 4 frames with changing overlay text."""
    jcfg = _jax_config(visualizer=JaxVisualizer[vis], **EMISSIONS[emission])
    cfg = port_config(jcfg)
    jpipe, pipe = JaxPipeline(jcfg), DeltaStreamPipeline(cfg, device="cpu")
    base, frames = _stream(cfg, rng)
    jprev, prev = jpipe.init_state(base), pipe.init_state(base)
    for frame, text in zip(frames, TEXTS):
        e = reference_cpu.step_oracle(np.asarray(jprev), frame, cfg,
                                      pipe.atlas_np, fonts.encode_text(text))
        jout = jpipe.step(jprev, frame, text=text)
        out = pipe.step(prev, frame, text=text)
        assert len(out) == len(jout)
        for a, b in zip(out, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(out[-1].numpy(), e[4])
        jprev, prev = jout[0], out[0]


@pytest.mark.parametrize("negfeed,thr", [(True, 0), (False, 20),
                                         (False, 0)],
                         ids=["thr0", "nofeed", "nofeed_thr0"])
@pytest.mark.parametrize("vis", ["RED_BLACK", "RED_OVERLAP"])
def test_red_mask_without_the_negfeed_shortcut(vis, negfeed, thr, rng):
    """The JAX pipeline takes ``new_prev != prev`` as the red modes' mask
    only under negative feedback with a positive threshold; the port
    takes ``|df| > thr`` before the kernel in every case: equal."""
    jcfg = _jax_config(visualizer=JaxVisualizer[vis], threshold=thr,
                       negative_feedback=negfeed)
    cfg = port_config(jcfg)
    jpipe, pipe = JaxPipeline(jcfg), DeltaStreamPipeline(cfg, device="cpu")
    base, frames = _stream(cfg, rng, n=2)
    frames[1][: cfg.frame_bytes // 2] = frames[0][: cfg.frame_bytes // 2]
    jprev, prev = jpipe.init_state(base), pipe.init_state(base)
    for frame, text in zip(frames, TEXTS):
        jout = jpipe.step(jprev, frame, text=text)
        out = pipe.step(prev, frame, text=text)
        for a, b in zip(out, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jprev, prev = jout[0], out[0]


def test_aux_never_aliases_the_state(rng):
    """The kernel rewrites prev in place after the visualizer read it:
    the aux frame returned beside it keeps the old bytes."""
    for vis in (Visualizer.RED_OVERLAP, Visualizer.HEATMAP):
        cfg = StreamConfig(height=48, width=64, overlay_scale=4,
                           visualizer=vis)
        pipe = DeltaStreamPipeline(cfg, device="cpu")
        base, frames = _stream(cfg, rng, n=2)
        prev = pipe.init_state(base)
        aux0 = pipe.step(prev, frames[0], text="12")[-1]
        want = aux0.clone()
        assert aux0.data_ptr() != prev.data_ptr()
        pipe.step(prev, frames[1], text="13")
        assert torch.equal(aux0, want)
        e = reference_cpu.step_oracle(base, frames[0], cfg, pipe.atlas_np,
                                      fonts.encode_text("12"))
        np.testing.assert_array_equal(want.numpy(), e[4])


@pytest.mark.parametrize("vis", [Visualizer.HEATMAP, Visualizer.BINARIZE])
def test_device_frame_is_never_written(vis, rng):
    """A tensor frame is used where it lies: the noise filter, the
    overlay and the visualizer read it and write new tensors."""
    cfg = StreamConfig(height=48, width=64, overlay_scale=4, visualizer=vis,
                       noise_filter=True)
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    base, frames = _stream(cfg, rng, n=1)
    frame = torch.from_numpy(frames[0].copy())
    out = pipe.step(pipe.init_state(base), frame, text="12")
    np.testing.assert_array_equal(frame.numpy(), frames[0])
    e = reference_cpu.step_oracle(base, frames[0], cfg, pipe.atlas_np,
                                  fonts.encode_text("12"))
    np.testing.assert_array_equal(out[-1].numpy(), e[4])
    np.testing.assert_array_equal(out[0].numpy(), e[0])


def _oracle_auxes(cfg, base, frames, texts):
    prev, auxes = base, []
    atlas = fonts.make_atlas(cfg.overlay_scale, cfg.overlay_font)
    for frame, text in zip(frames, texts):
        prev, _, _, _, aux = reference_cpu.step_oracle(
            prev, frame, cfg, atlas, fonts.encode_text(text) if text else None)
        auxes.append(aux)
    return auxes


def _flatten(results):
    out = []
    for r in results:
        if isinstance(r, list):
            out.extend(r)
        elif r is not None:
            out.append(r)
    return out


@pytest.mark.parametrize("kind", ["flat", "tiles", "flat_landing", "mask",
                                  "pipelined", "batched"])
def test_executors_land_aux(kind, rng):
    """Every executor under every landing flavor lands each frame's aux
    frame as a host uint8 array equal to the NumPy spec's, in order."""
    kw = {"flat": {}, "tiles": dict(tiled_payload=True, fetch_mode="tiles"),
          "flat_landing": dict(tiled_payload=True, fetch_mode="flat"),
          "mask": EMISSIONS["maskonly"],
          "pipelined": dict(tiled_payload=True),
          "batched": dict(tiled_payload=True, emit_bitmask=True)}[kind]
    cfg = StreamConfig(height=48, width=64, overlay_scale=4,
                       visualizer=Visualizer.BINARIZE, noise_filter=True,
                       **kw)
    base, frames = _stream(cfg, rng, n=5)
    frames[2] = frames[1].copy()  # an empty frame lands its aux too
    if kind == "pipelined":
        ex = PipelinedExecutor(cfg, device="cpu")
    elif kind == "batched":
        ex = BatchedLandExecutor(cfg, device="cpu", depth=2)
    else:
        ex = StreamExecutor(cfg, device="cpu")
    ex.start(base)
    texts = ["12", "12", "12", "13", ""]
    got = _flatten([ex.process(f, text=t) for f, t in zip(frames, texts)]
                   + [ex.flush()])
    assert len(got) == len(frames)
    assert got[2][0] == 0
    for (pos, xs, vals, aux), want in zip(got, _oracle_auxes(
            cfg, base, frames, texts)):
        assert isinstance(aux, np.ndarray) and aux.dtype == np.uint8
        np.testing.assert_array_equal(aux, want)


@pytest.mark.parametrize("emission", ["flat", "tiled", "maskonly"])
def test_executor_aux_matches_jax_executor(emission, rng):
    """The port's StreamExecutor against the JAX package's, heatmap over
    the noise filter: the same payloads and the same aux arrays."""
    kw = {} if emission == "flat" else EMISSIONS[emission]
    jcfg = _jax_config(visualizer=JaxVisualizer.HEATMAP, noise_filter=True,
                       **kw)
    ours = StreamExecutor(port_config(jcfg), device="cpu")
    theirs = JaxExecutor(jcfg)
    base, frames = _stream(jcfg, rng)
    ours.start(base)
    theirs.start(base)
    for frame, text in zip(frames, TEXTS):
        a, b = ours.process(frame, text=text), theirs.process(frame,
                                                               text=text)
        assert a[0] == b[0]
        fa = a[1:3] if a[2] is not None else a[1].to_flat()
        fb = b[1:3] if b[2] is not None else b[1].to_flat()
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[3], b[3])


def test_overflow_drops_the_aux(rng):
    """A frame past the payload capacity raises, and its aux frame goes
    with it; the next frame lands its own."""
    cfg = StreamConfig(height=48, width=64, payload_capacity=64,
                       visualizer=Visualizer.GRAYSCALE)
    ex = StreamExecutor(cfg, device="cpu")
    base = np.zeros(cfg.frame_bytes, np.uint8)
    ex.start(base)
    with pytest.raises(PayloadOverflowError):
        ex.process(np.full(cfg.frame_bytes, 200, np.uint8))
    frame = np.full(cfg.frame_bytes, 200, np.uint8)
    frame[:30] = 0
    pos, _, _, aux = ex.process(frame)
    assert pos == 30
    np.testing.assert_array_equal(aux,
                                  reference_cpu.grayscale_weighted(frame))


def test_write_ppm_is_the_jax_format(tmp_path, rng):
    frame = rng.integers(0, 256, 6 * 5 * 3, dtype=np.uint8)
    write_ppm(str(tmp_path / "a.ppm"), frame, 6, 5)
    jax_write_ppm(str(tmp_path / "b.ppm"), frame, 6, 5)
    a = (tmp_path / "a.ppm").read_bytes()
    assert a == (tmp_path / "b.ppm").read_bytes()
    assert a.startswith(b"P6\n5 6\n255\n")
    assert a[11:14] == frame[2::-1].tobytes()  # BGR -> RGB


@pytest.mark.parametrize("vis", [1, 5])
def test_aux_dir_loopback_matches_jax(tmp_path, rng, vis):
    """Over a real socket with ``aux_dir``: the client decodes every frame
    byte-exact, and the dumped PPM files hold the JAX pipeline's aux
    frames, byte for byte, as the JAX package's write_ppm writes them."""
    jcfg = _jax_config(visualizer=JaxVisualizer(vis), port=0)
    cfg = port_config(jcfg)
    base, frames = _stream(cfg, rng, n=5)
    server = DeltaStreamServer(cfg, ScriptedSource(base, frames),
                               verbose=False, overlay_status=False,
                               device="cpu", aux_dir=str(tmp_path / "port"),
                               aux_every=2)
    os.makedirs(tmp_path / "port")
    errors = []

    def run():
        try:
            server.serve(max_frames=len(frames))
        except BaseException as e:
            errors.append(e)

    server.listen()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    cli = DeltaStreamClient("127.0.0.1", server.port, cfg.height, cfg.width)
    cli.connect()
    jpipe = JaxPipeline(jcfg)
    jprev = jpipe.init_state(base)
    os.makedirs(tmp_path / "jax")
    for k, frame in enumerate(frames):
        pos, recon = cli.read_frame()
        jout = jpipe.step(jprev, frame)
        jprev = jout[0]
        assert pos == int(jout[1])
        np.testing.assert_array_equal(recon, np.asarray(jprev))
        if k % 2 == 0:
            jax_write_ppm(str(tmp_path / "jax" / f"aux_{k:06d}.ppm"),
                          np.asarray(jout[-1]), cfg.height, cfg.width)
    cli.close()
    t.join(timeout=30)
    server.close()
    assert not t.is_alive() and not errors
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == ["aux_000000.ppm", "aux_000002.ppm", "aux_000004.ppm"]
    assert names == sorted(os.listdir(tmp_path / "jax"))
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


@pytest.mark.parametrize("flags,want", [
    (["--visualizer", "5"], dict(visualizer=Visualizer.BINARIZE)),
    (["--visualizer", "1", "--noise-filter", "--conv-k", "5"],
     dict(visualizer=Visualizer.HEATMAP, noise_filter=True, conv_k=5)),
    (["--tiled", "--fetch", "mask", "--maskonly", "--visualizer", "3"],
     dict(visualizer=Visualizer.RED_OVERLAP, maskonly_payload=True)),
    (["--noise-filter"], dict(noise_filter=True, conv_k=3,
                              visualizer=Visualizer.NONE)),
    (["--visualizer", "6"], SystemExit),
    (["--conv-k", "16", "--noise-filter"], ValueError),
    (["--aux-port", "0", "--visualizer", "1"],
     dict(visualizer=Visualizer.HEATMAP)),
], ids=["binarize", "heatmap_denoised", "maskonly_red_overlap",
        "noise_filter", "bad_visualizer", "bad_conv_k", "aux_port"])
def test_server_main_visualizer_flags(flags, want, tmp_path, monkeypatch):
    """The JAX server's --visualizer, --noise-filter, --conv-k, --aux-dir
    and --aux-port map to the config and the server (--aux-port to its
    live aux sink)."""
    served = []
    monkeypatch.setattr(server_mod.DeltaStreamServer, "serve",
                        lambda self, max_frames=None: served.append(self)
                        or 0)
    aux_dir = str(tmp_path / "aux")
    args = ["--device", "cpu", "--frames", "1", "--height", "48", "--width",
            "64", "--aux-dir", aux_dir] + flags
    if isinstance(want, type):
        with pytest.raises(want):
            server_mod.main(args)
        assert not served
        return
    assert server_mod.main(args) == 0
    (srv,) = served
    for k, v in want.items():
        assert getattr(srv.cfg, k) == v, k
    assert srv.aux_dir == aux_dir and srv.aux_every == 30
    assert (srv.aux_sink is not None) == ("--aux-port" in flags)
    assert os.path.isdir(aux_dir)


def test_histogram_counts_only_binarize(rng):
    """On the CPU the wrapper counts no launch (the plain version runs);
    every visualizer and the noise filter leave the count alone there."""
    before = hist.histogram.launches
    for vis in Visualizer:
        cfg = StreamConfig(height=48, width=64, visualizer=vis,
                           noise_filter=True)
        pipe = DeltaStreamPipeline(cfg, device="cpu")
        base, frames = _stream(cfg, rng, n=1)
        pipe.step(pipe.init_state(base), frames[0])
    assert hist.histogram.launches == before


def test_mask_payload_aux_through_v4(rng):
    """A MaskPayload landing under wire v4 carries its aux as the flat
    landings do."""
    cfg = dataclasses.replace(
        StreamConfig(height=48, width=64, overlay_scale=4,
                     visualizer=Visualizer.GRAYSCALE),
        mask_payload=True, wire_format="v4", **EMISSIONS["maskonly"])
    ex = StreamExecutor(cfg, device="cpu")
    base, frames = _stream(cfg, rng, n=2)
    ex.start(base)
    for frame in frames:
        pos, mp, vals, aux = ex.process(frame)
        assert isinstance(mp, wire.MaskPayload) and vals is None
        np.testing.assert_array_equal(
            aux, reference_cpu.grayscale_weighted(frame))
