"""The port's examples (``cudavideostream_tpu_torch/examples``) against
the JAX package's scripts under ``examples/``, on the CPU, at reduced
sizes and frame counts, written to ``tmp_path``."""

import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from cudavideostream_tpu.models import DeltaStreamPipeline as JaxPipeline
from cudavideostream_tpu.models import variants as jax_variants
from cudavideostream_tpu.runtime.sources import SyntheticSource as JaxSource
from cudavideostream_tpu_torch.examples import classical_heatmap
from cudavideostream_tpu_torch.examples import make_artifacts
from cudavideostream_tpu_torch.examples import stream_demo

REPO = Path(__file__).resolve().parents[1]
H, W, FRAMES = 48, 64, 2


def _jax_demo_lines(frames):
    """The JAX demo's lines (``examples/stream_demo.py``: the same loop
    and format), with the step's outputs read by position: the JAX
    script itself stops at ``delta-maskonly``, whose step returns six
    values where it unpacks five."""
    lines, aux_by_name, state = [], {}, None
    for name in jax_variants.available():
        cfg = jax_variants.get_config(name, height=H, width=W)
        pipe = JaxPipeline(cfg)
        src = JaxSource(cfg, seed=4)
        state = pipe.init_state(src.base_frame())
        total, aux = 0, None
        for t in range(frames):
            out = pipe.step(state, next(src), text=f"FPS: {30+t}")
            state, pos, aux = out[0], out[1], out[-1]
            total += 4 + 5 * int(pos)
        dense = frames * cfg.frame_bytes
        line = (f"{name:16s} payload {total/1024:8.1f} KiB "
                f"({100*total/dense:5.2f}% of dense)")
        if cfg.visualizer.value != 0:
            aux_np = np.asarray(aux)
            line += f"   aux mean {aux_np.mean():6.1f}"
            aux_by_name[name] = aux_np
        lines.append(line)
    return lines, aux_by_name, np.asarray(state)


def _ppm_pixels(path):
    data = path.read_bytes()
    head = b"P6\n%d %d\n255\n" % (W, H)
    assert data.startswith(head)
    return np.frombuffer(data[len(head):], np.uint8)


def test_stream_demo_lines_equal_the_jax_demo(tmp_path, capsys, monkeypatch):
    out = tmp_path / "port"
    assert stream_demo.main(["--height", str(H), "--width", str(W),
                             "--frames", str(FRAMES), "--out", str(out),
                             "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    want, aux, state = _jax_demo_lines(FRAMES)
    assert got[:-1] == want
    assert got[-1] == f"viewable PPM dumps in {out}/"
    # the PPMs hold the JAX pipeline's aux frames and last state, RGB
    for name, frame in aux.items():
        rgb = frame.reshape(H, W, 3)[:, :, ::-1].ravel()
        np.testing.assert_array_equal(_ppm_pixels(out / f"{name}_aux.ppm"),
                                      rgb)
    np.testing.assert_array_equal(
        _ppm_pixels(out / "reconstruction.ppm"),
        state.reshape(H, W, 3)[:, :, ::-1].ravel())
    # the JAX script prints the same lines up to the variant it cannot
    # unpack
    monkeypatch.setattr(sys, "argv", [
        "stream_demo.py", "--height", str(H), "--width", str(W),
        "--frames", str(FRAMES), "--out", str(tmp_path / "jax")])
    with pytest.raises(ValueError, match="unpack"):
        runpy.run_path(str(REPO / "examples" / "stream_demo.py"),
                       run_name="__main__")
    jax_lines = capsys.readouterr().out.splitlines()
    assert jax_lines and jax_lines == got[:len(jax_lines)]


def test_stream_demo_runs_on_the_card_by_default(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        stream_demo.main(["--out", str(tmp_path)])


def _jax_example(name, monkeypatch, out, **constants):
    """Import the JAX package's ``examples/<name>.py`` with its output
    directory (and any other module constant) set for the test."""
    monkeypatch.syspath_prepend(str(REPO))
    import importlib

    mod = importlib.import_module(f"examples.{name}")
    monkeypatch.setattr(mod, "OUT", str(out))
    for k, v in constants.items():
        monkeypatch.setattr(mod, k, v)
    out.mkdir(parents=True, exist_ok=True)
    return mod


@pytest.mark.parametrize("n_frames", [6, 9])
def test_make_artifacts_sessions_equal_the_jax_script(n_frames, tmp_path,
                                                      monkeypatch):
    jmod = _jax_example("make_artifacts", monkeypatch, tmp_path / "jax")
    port = tmp_path / "port"
    port.mkdir()
    make_artifacts.record_session(str(port), n_frames=n_frames)
    make_artifacts.record_session_v3(str(port), n_frames=n_frames)
    jmod.record_session(n_frames=n_frames)
    jmod.record_session_v3(n_frames=n_frames)
    for f in ("session.cvs.gz", "session_final.png", "session_v3.cvs.gz"):
        assert (port / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_make_artifacts_demo_scene_equals_the_jax_script(monkeypatch,
                                                         tmp_path):
    jmod = _jax_example("make_artifacts", monkeypatch, tmp_path / "jax")
    from cudavideostream_tpu.config import StreamConfig as JaxConfig
    from cudavideostream_tpu_torch.config import StreamConfig

    for t, noise in ((0, 0), (7, 0), (3, 12)):
        got = make_artifacts.demo_scene(StreamConfig(height=90, width=120),
                                        t, np.random.default_rng(t), noise)
        want = jmod.demo_scene(JaxConfig(height=90, width=120), t,
                               np.random.default_rng(t), noise)
        np.testing.assert_array_equal(got, want)


def test_make_artifacts_visualizers_equal_the_jax_script(tmp_path,
                                                         monkeypatch):
    """The five aux PNGs and the scene at 1080p, from two frames."""
    jmod = _jax_example("make_artifacts", monkeypatch, tmp_path / "jax")
    port = tmp_path / "port"
    port.mkdir()
    make_artifacts.render_visualizers(str(port), n_frames=2)
    jmod.render_visualizers(n_frames=2)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 6 and "scene.png" in names
    assert sorted(p.name for p in port.iterdir()) == names
    for f in names:
        assert (port / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_make_artifacts_main_writes_under_out_only(tmp_path, monkeypatch):
    calls = []
    for fn in ("render_visualizers", "record_session", "record_session_v3"):
        monkeypatch.setattr(make_artifacts, fn,
                            lambda out, _fn=fn: calls.append((_fn, out)))
    out = tmp_path / "a" / "b"
    assert make_artifacts.main(["--out", str(out)]) == 0
    assert out.is_dir()
    assert [c[0] for c in calls] == ["render_visualizers", "record_session",
                                     "record_session_v3"]
    assert {c[1] for c in calls} == {str(out)}
    # the default is under build/, never the JAX package's committed
    # examples/artifacts/
    default = Path(make_artifacts.DEFAULT_OUT)
    assert default.relative_to(REPO).parts[0] == "build"


def test_classical_heatmap_pngs_equal_the_jax_script(tmp_path, monkeypatch,
                                                     capsys):
    frames = 6
    jmod = _jax_example("classical_heatmap", monkeypatch, tmp_path / "jax",
                        N_FRAMES=frames)
    assert jmod.main() == 0
    want = capsys.readouterr().out.splitlines()
    port = tmp_path / "port"
    assert classical_heatmap.main(["--out", str(port), "--frames",
                                   str(frames)]) == 0
    got = capsys.readouterr().out.splitlines()
    for f in ("classical_mog2_heatmap.png", "delta_mask_heatmap.png"):
        assert (port / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    # the same trails and IoU, each file named under its own directory
    assert [s.replace(str(port), "OUT") for s in got] == \
        [s.replace(str(tmp_path / "jax"), "OUT") for s in want]
    assert got[-1].startswith("trail IoU classical vs delta-mask: ")
    assert Path(classical_heatmap.DEFAULT_OUT).relative_to(REPO).parts[0] \
        == "build"


def test_classical_heatmap_pieces_equal_the_jax_script(monkeypatch,
                                                       tmp_path):
    jmod = _jax_example("classical_heatmap", monkeypatch, tmp_path / "jax")
    v = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(classical_heatmap.hot_colormap(v),
                                  jmod.hot_colormap(v))
    frame = np.random.default_rng(2).integers(0, 255, (9, 11, 3),
                                              endpoint=True, dtype=np.uint8)
    np.testing.assert_array_equal(classical_heatmap.bgr_to_gray(frame),
                                  jmod.bgr_to_gray(frame))
    g0 = jmod.bgr_to_gray(frame)
    a = classical_heatmap.RunningGaussianBackground(g0)
    b = jmod.RunningGaussianBackground(g0)
    for k in range(3):
        g = g0 + 40.0 * (k % 2)
        np.testing.assert_array_equal(a.apply(g), b.apply(g))
    np.testing.assert_array_equal(a.var, b.var)
