"""The port's frame sources on the CPU against the JAX package's: the file
and camera sources, the prefetch thread, the synthetic scene and the device
generator on the same inputs, made from a seed with numpy; and the port's
``server``, ``multiserve`` and ``broadcast`` command lines serving a file
through loopback clients, byte-exact against ``step_oracle``.

The camera is replayed through a stand-in for the native library, as the
JAX package's own tests do (``tests/test_runtime.py``). Every socket has a
timeout and every thread is joined with one.
"""

import dataclasses
import functools
import gc
import io
import re
import socket
import threading

import jax
import numpy as np
import pytest
import torch

from conftest import ScriptedSource
from cudavideostream_tpu import native as jax_native
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.runtime import broadcast as jax_broadcast
from cudavideostream_tpu.runtime import server as jax_server
from cudavideostream_tpu.runtime import sources as jax_sources
from cudavideostream_tpu.runtime.executor import ExecMetrics as JaxMetrics
from cudavideostream_tpu_torch import native
from cudavideostream_tpu_torch.config import StreamConfig
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.runtime import broadcast
from cudavideostream_tpu_torch.runtime import multiserve
from cudavideostream_tpu_torch.runtime import server as server_mod
from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
from cudavideostream_tpu_torch.runtime.executor import ExecMetrics
from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer
from cudavideostream_tpu_torch.runtime.sources import (
    FileSource,
    FrameSource,
    PrefetchSource,
    SyntheticSource,
    V4L2Source,
    decode_mjpg_frame,
    device_synthetic_frames,
    make_source,
)

H, W = 48, 64
TIMEOUT = 30


@pytest.fixture
def cfg():
    return StreamConfig(height=H, width=W, overlay_scale=4, port=0)


@pytest.fixture
def jcfg():
    return JaxConfig(height=H, width=W, overlay_scale=4)


@pytest.fixture
def timed_connections(monkeypatch):
    """Every client socket a test opens through ``create_connection``
    (the port's client, the JAX one) gets the test's timeout."""
    monkeypatch.setattr(socket, "create_connection", functools.partial(
        socket.create_connection, timeout=TIMEOUT))


def _clip(rng, n, cfg, shape="flat"):
    frames = rng.integers(0, 255, (n, cfg.frame_bytes), endpoint=True,
                          dtype=np.uint8)
    return frames if shape == "flat" else frames.reshape(n, H, W, 3)


# -- FileSource --------------------------------------------------------------

@pytest.mark.parametrize("shape", ["flat", "hwc"])
def test_file_source_npy_matches_jax(shape, tmp_path, rng, cfg, jcfg):
    """``(n, H*W*3)`` and ``(n, H, W, 3)`` stacks, looping past the end:
    every frame equal to the JAX FileSource's and to the stack's."""
    frames = _clip(rng, 4, cfg, shape)
    path = str(tmp_path / "clip.npy")
    np.save(path, frames)
    ours, theirs = FileSource(path, cfg), jax_sources.FileSource(path, jcfg)
    for i in range(10):
        got = next(ours)
        np.testing.assert_array_equal(got, next(theirs))
        np.testing.assert_array_equal(got, frames[i % 4].ravel())
        assert got.dtype == np.uint8 and got.shape == (cfg.frame_bytes,)


def test_file_source_raw_matches_jax(tmp_path, rng, cfg, jcfg):
    """A raw BGR24 file with a partial frame at its end: the whole frames,
    looped, as the JAX source reads them."""
    frames = _clip(rng, 3, cfg)
    path = str(tmp_path / "clip.bgr")
    with open(path, "wb") as f:
        f.write(frames.tobytes() + b"\x01" * 100)
    ours, theirs = FileSource(path, cfg), jax_sources.FileSource(path, jcfg)
    for i in range(7):
        got = next(ours)
        np.testing.assert_array_equal(got, next(theirs))
        np.testing.assert_array_equal(got, frames[i % 3])


def test_file_source_without_loop_ends(tmp_path, rng, cfg, jcfg):
    frames = _clip(rng, 2, cfg)
    path = str(tmp_path / "clip.npy")
    np.save(path, frames)
    for src in (FileSource(path, cfg, loop=False),
                jax_sources.FileSource(path, jcfg, loop=False)):
        assert len(list(src)) == 2


@pytest.mark.parametrize("case", ["npy_width", "raw_short"])
def test_file_source_refuses_a_size_mismatch(case, tmp_path, rng, cfg, jcfg):
    """A stack of another frame size, or a raw file shorter than a frame:
    ``ValueError`` from both packages."""
    if case == "npy_width":
        path = str(tmp_path / "bad.npy")
        np.save(path, rng.integers(0, 255, (2, 100), dtype=np.int64))
        match = "frame size 100"
    else:
        path = str(tmp_path / "bad.bgr")
        with open(path, "wb") as f:
            f.write(bytes(cfg.frame_bytes - 1))
        match = "smaller than one frame"
    with pytest.raises(ValueError, match=match):
        FileSource(path, cfg)
    with pytest.raises(ValueError, match=match):
        jax_sources.FileSource(path, jcfg)


def test_make_source_kinds(tmp_path, rng, cfg, jcfg):
    path = str(tmp_path / "clip.npy")
    np.save(path, _clip(rng, 2, cfg))
    assert isinstance(make_source("file", cfg, path=path), FileSource)
    assert isinstance(make_source("synthetic", cfg, path=path),
                      SyntheticSource)
    for kind, err, match in (("file", ValueError, "needs --path"),
                             ("webcam9000", ValueError, "unknown source")):
        with pytest.raises(err, match=match):
            make_source(kind, cfg)
        with pytest.raises(err, match=match):
            jax_sources.make_source(kind, jcfg)
    with pytest.raises(RuntimeError, match="/nonexistent/video9 not present"):
        make_source("v4l2", cfg, path="/nonexistent/video9")


# -- SyntheticSource -----------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"noise": 0}, {"object_size": 7},
                                {"speed": 5, "noise": 3},
                                {"noise": 0, "object_size": 1000,
                                 "speed": 1}])
def test_synthetic_source_options_match_jax(kw, cfg, jcfg):
    ours = SyntheticSource(cfg, seed=11, **kw)
    theirs = jax_sources.SyntheticSource(jcfg, seed=11, **kw)
    for _ in range(5):
        np.testing.assert_array_equal(next(ours), next(theirs))


# -- MJPG decode -------------------------------------------------------------

def _jpeg(height, width, seed=0):
    from PIL import Image

    img = np.random.default_rng(seed).integers(
        0, 255, (height, width, 3), endpoint=True, dtype=np.uint8)
    out = io.BytesIO()
    Image.fromarray(img).save(out, format="JPEG", quality=90)
    return out.getvalue()


def test_decode_mjpg_frame_matches_jax():
    for seed in range(3):
        data = _jpeg(H, W, seed)
        got = decode_mjpg_frame(data, H, W)
        np.testing.assert_array_equal(
            got, jax_sources.decode_mjpg_frame(data, H, W))
        assert got.shape == (H * W * 3,) and got.dtype == np.uint8


@pytest.mark.parametrize("data,match", [
    (b"\xde\xad\xbe\xef" * 100, "MJPG frame decode failed"),
    (b"", "MJPG frame decode failed"),
    (None, "MJPG frame is 64x24, expected 64x48"),
])
def test_decode_mjpg_frame_errors_match_jax(data, match):
    data = _jpeg(H // 2, W) if data is None else data
    with pytest.raises(RuntimeError, match=match):
        decode_mjpg_frame(data, H, W)
    with pytest.raises(RuntimeError, match=match):
        jax_sources.decode_mjpg_frame(data, H, W)


# -- V4L2Source, through a stand-in library ------------------------------------

class _FakeV4L2Lib:
    """The native library's camera functions, replaying recorded grabs:
    byte payloads, or an int return code."""

    def __init__(self, open_rc, grabs):
        self.open_rc = open_rc  # 0 BGR24, 1 MJPG, < 0 an error
        self.grabs = list(grabs)
        self.open_calls, self.close_calls = [], 0

    def v4l2_open(self, device, width, height):
        self.open_calls.append((device, width, height))
        return self.open_rc

    def v4l2_grab(self, handle, buf_ptr, size):
        import ctypes

        if not self.grabs:
            return -5
        item = self.grabs.pop(0)
        if isinstance(item, int):
            return item
        assert len(item) <= size
        ctypes.memmove(buf_ptr, item, len(item))
        return len(item)

    def v4l2_close(self, handle):
        self.close_calls += 1


def _camera(kind, monkeypatch, open_rc, grabs, config):
    """A V4L2Source of the port (``kind`` "port") or of the JAX package on
    a stand-in library; /dev/null passes the device check. Returns the
    source, or the exception its construction raised, and the stand-in."""
    fake = _FakeV4L2Lib(open_rc, grabs)
    with monkeypatch.context() as m:
        if kind == "port":
            m.setattr(native, "load", lambda: fake)
            make = lambda: V4L2Source(config, device="/dev/null")  # noqa: E731
        else:
            m.setattr(jax_native, "load_native", lambda: fake)
            make = lambda: jax_sources.V4L2Source(  # noqa: E731
                JaxConfig(height=config.height, width=config.width),
                device="/dev/null")
        try:
            return make(), fake
        except RuntimeError as e:
            return e, fake


def _outcomes(src, n):
    """The first ``n`` grabs: each frame, or the error it raised."""
    out = []
    for _ in range(n):
        try:
            out.append(next(src).copy())
        except RuntimeError as e:
            out.append(str(e))
    return out


def _bgr(n, seed):
    return np.random.default_rng(seed).integers(
        0, 255, n, endpoint=True, dtype=np.uint8).tobytes()


V4L2_CASES = {
    "mjpg": (1, lambda n: [_jpeg(H, W, 1), _jpeg(H, W, 2)], 2),
    "bgr24_then_short": (0, lambda n: [_bgr(n, 3), _bgr(n, 4)[:n - 7]], 2),
    "grab_error": (0, lambda n: [-7], 1),
    "decode_error": (1, lambda n: [b"\xde\xad\xbe\xef" * 100], 1),
    "geometry": (1, lambda n: [_jpeg(H // 2, W)], 1),
    "exhausted": (0, lambda n: [_bgr(n, 5)], 3),
}


@pytest.mark.parametrize("case", list(V4L2_CASES))
def test_v4l2_grab_loop_matches_jax(case, cfg, monkeypatch):
    """Recorded grabs replayed through both packages' grab loops: the
    same frames and the same errors, grab by grab (MJPG decoded; BGR24
    copied; a short frame, a grab error, a decode error and a geometry
    error raised), and the camera released once on close."""
    open_rc, grabs, n = V4L2_CASES[case]
    results = {}
    for kind in ("port", "jax"):
        src, fake = _camera(kind, monkeypatch, open_rc,
                            grabs(cfg.frame_bytes), cfg)
        assert fake.open_calls == [(b"/dev/null", W, H)]
        results[kind] = _outcomes(src, n)
        src.close()
        src.close()  # idempotent
        assert fake.close_calls == 1
    for a, b in zip(results["port"], results["jax"]):
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    if case == "mjpg":
        np.testing.assert_array_equal(
            results["port"][0], decode_mjpg_frame(_jpeg(H, W, 1), H, W))
    if case == "bgr24_then_short":
        assert results["port"][1] == (f"short BGR24 frame: "
                                      f"{cfg.frame_bytes - 7} of "
                                      f"{cfg.frame_bytes} bytes")


@pytest.mark.parametrize("open_rc,match", [
    (-2000, "neither BGR24 nor MJPG at 64x48"),
    (-13, r"v4l2_open\(/dev/null\) failed: -13"),
])
def test_v4l2_open_refusals_match_jax(open_rc, match, cfg, monkeypatch):
    for kind in ("port", "jax"):
        err, fake = _camera(kind, monkeypatch, open_rc, [], cfg)
        assert isinstance(err, RuntimeError) and fake.open_calls
        assert re.search(match, str(err))
    with pytest.raises(RuntimeError, match="/nonexistent/video9 not present"):
        V4L2Source(cfg, device="/nonexistent/video9")


def test_v4l2_decode_error_releases_the_camera(cfg, monkeypatch):
    """A decode error mid-stream abandons the source: dropping it still
    releases the process-wide camera handle (``__del__``)."""
    src, fake = _camera("port", monkeypatch, 1, [b"\x00" * 400], cfg)
    with pytest.raises(RuntimeError, match="MJPG frame decode failed"):
        next(src)
    del src
    gc.collect()
    assert fake.close_calls == 1


def test_v4l2_source_serves_through_the_port_server(cfg, monkeypatch,
                                                    timed_connections):
    """Camera frames drive the port's server and client over a socket:
    the client's base frame is the first grab, and each state the
    oracle's."""
    monkeypatch.setattr(ExecMetrics, "status_line", lambda self, *a: None)
    raws = [np.frombuffer(_bgr(cfg.frame_bytes, s), np.uint8)
            for s in range(4)]
    src, fake = _camera("port", monkeypatch, 0, [r.tobytes() for r in raws],
                        cfg)
    server = DeltaStreamServer(cfg, src, verbose=False, device="cpu")
    server.listen()
    t = threading.Thread(target=server.serve, kwargs={"max_frames": 3},
                         daemon=True)
    t.start()
    cli = DeltaStreamClient("127.0.0.1", server.port, H, W)
    cli.connect()
    np.testing.assert_array_equal(cli.frame, raws[0])
    prev = raws[0]
    for k in range(3):
        prev = ref.step_oracle(prev, raws[k + 1], cfg)[0]
        np.testing.assert_array_equal(cli.read_frame()[1], prev)
    cli.close()
    t.join(TIMEOUT)
    server.close()
    src.close()
    assert not t.is_alive() and fake.close_calls == 1


def test_v4l2_open_on_a_missing_path_through_the_real_library(tmp_path):
    """The real ``v4l2_open`` on a path that is not there: ``-ENOENT``,
    and the library's handle stays free."""
    lib = native.load()
    assert lib.v4l2_open(str(tmp_path / "video9").encode(), W, H) == -2
    assert lib.v4l2_grab(0, None, 0) == -1  # no camera open
    lib.v4l2_close(0)


# -- PrefetchSource ------------------------------------------------------------

def _script(cfg, n=5):
    base = np.zeros(cfg.frame_bytes, np.uint8)
    return base, [np.full(cfg.frame_bytes, i + 1, np.uint8) for i in range(n)]


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_order_and_end_match_jax(depth, cfg):
    """The base frame synchronously, then every frame in order, then
    StopIteration (and again on a later call), as the JAX source does."""
    base, frames = _script(cfg)
    ours = PrefetchSource(ScriptedSource(base, frames), depth=depth)
    theirs = jax_sources.PrefetchSource(ScriptedSource(base, frames),
                                        depth=depth)
    np.testing.assert_array_equal(ours.base_frame(), base)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == len(frames)
    for g, w, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, f)
    with pytest.raises(StopIteration):
        next(ours)
    ours.close()
    theirs.close()


class _Dying(FrameSource):
    def __init__(self, cfg, after):
        self.cfg, self.n, self.after = cfg, 0, after
        self.closed = False

    def __next__(self):
        self.n += 1
        if self.n > self.after:
            raise RuntimeError("camera died")
        return np.full(self.cfg.frame_bytes, self.n, np.uint8)

    def close(self):
        self.closed = True


def test_prefetch_raises_the_source_error_again(cfg):
    for cls in (PrefetchSource, jax_sources.PrefetchSource):
        inner = _Dying(cfg, 2)
        src = cls(inner)
        assert next(src)[0] == 1 and next(src)[0] == 2
        with pytest.raises(RuntimeError, match="camera died"):
            next(src)
        src.close()
        assert inner.closed


def test_prefetch_close_joins_the_thread(cfg):
    """``close`` stops a thread blocked on a full queue, joins it within
    its timeout and closes the inner source; a bad depth is refused."""
    inner = _Dying(cfg, 10**9)
    src = PrefetchSource(inner)
    next(src)
    thread = src._thread
    assert thread.is_alive()
    src.close()
    assert not thread.is_alive() and inner.closed
    for cls in (PrefetchSource, jax_sources.PrefetchSource):
        with pytest.raises(ValueError, match="depth"):
            cls(SyntheticSource(cfg), depth=0)


def _wire_bytes(cfg, source, n_frames):
    """Every byte the port's server sends for ``n_frames`` frames."""
    server = DeltaStreamServer(cfg, source, verbose=False,
                               overlay_status=False, device="cpu")
    server.listen()
    t = threading.Thread(target=server.serve,
                         kwargs={"max_frames": n_frames}, daemon=True)
    t.start()
    chunks = []
    with socket.create_connection(("127.0.0.1", server.port),
                                  timeout=TIMEOUT) as sock:
        while chunk := sock.recv(1 << 16):
            chunks.append(chunk)
    t.join(TIMEOUT)
    server.close()
    assert not t.is_alive()
    return b"".join(chunks)


@pytest.mark.parametrize("tiled", [False, True])
def test_prefetch_wire_bytes_equal_inline_capture(cfg, tiled):
    """``--prefetch`` sends the bytes of inline capture: the thread drops
    and reorders nothing."""
    cfg = dataclasses.replace(cfg, tiled_payload=tiled)
    inline = _wire_bytes(cfg, SyntheticSource(cfg, seed=13), 6)
    pf = PrefetchSource(SyntheticSource(cfg, seed=13))
    assert _wire_bytes(cfg, pf, 6) == inline
    pf.close()


# -- the device generator ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("noise_bank", [0, 8])
def test_device_synthetic_frames_match_jax(seed, noise_bank, cfg, jcfg):
    """The port's generator on the CPU, given the JAX generator's ``init``
    as its background and each step's key words: the JAX generator's
    frames bit for bit, over steps that move the box across the frame and
    cycle the bank."""
    init, next_frame = jax_sources.device_synthetic_frames(
        jcfg, seed=seed, noise_bank=noise_bank)
    p_init, p_next = device_synthetic_frames(cfg, seed=seed,
                                             noise_bank=noise_bank,
                                             device="cpu",
                                             background=np.asarray(init))
    np.testing.assert_array_equal(p_init.numpy(), np.asarray(init))
    key = jax.random.PRNGKey(seed + 100)
    for t in (0, 1, 2, 3, 7, 8, 9, 17, 40):
        key, sub = jax.random.split(key)
        want = np.asarray(next_frame(sub, t))
        got = p_next(np.asarray(jax.random.key_data(sub)), t)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def test_device_synthetic_frames_own_background(cfg):
    """Without a given background: ``default_rng(seed)`` integers in
    [0, 255], the same on every call; frames uint8 of the frame's length
    whose box is 255; a background of another length is refused."""
    init, next_frame = device_synthetic_frames(cfg, seed=3, device="cpu")
    want = np.random.default_rng(3).integers(0, 255, cfg.frame_bytes,
                                             endpoint=True, dtype=np.uint8)
    np.testing.assert_array_equal(init.numpy(), want)
    f0 = next_frame([1, 2], 0).numpy()
    np.testing.assert_array_equal(f0, next_frame([1, 2], 0).numpy())
    assert f0.shape == (cfg.frame_bytes,) and f0.dtype == np.uint8
    s = min(200, H // 2, W // 2)
    assert (f0.reshape(H, W, 3)[:s, :s] == 255).all()
    assert not np.array_equal(f0, next_frame([1, 3], 0).numpy())
    noise = f0.astype(np.int32) - want
    outside = np.ones((H, W, 3), bool)
    outside[:s, :s] = False
    assert np.abs(noise.reshape(H, W, 3)[outside]).max() <= 10
    with pytest.raises(ValueError, match="background"):
        device_synthetic_frames(cfg, background=np.zeros(5, np.uint8))


def test_device_synthetic_frames_default_to_the_card(cfg, monkeypatch):
    """With no device the generator runs on the card, as every entry
    point of the port: where there is none it raises, never falling back
    to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        device_synthetic_frames(cfg, seed=3)


def test_device_frames_step_equals_oracle(cfg):
    """A generated frame chained into ``pipeline.step`` on the CPU: the
    step's state and payload equal ``step_oracle``'s."""
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline

    init, next_frame = device_synthetic_frames(cfg, seed=2, noise_bank=4,
                                               device="cpu")
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    prev = pipe.init_state(init.numpy())
    prev_np = init.numpy().copy()
    for t in range(3):
        frame = next_frame(None, t)
        new_prev, pos, xs, vals, _ = pipe.step(prev, frame)
        e_prev, e_pos, e_xs, e_vals, _ = ref.step_oracle(
            prev_np, frame.numpy(), cfg)
        assert int(pos) == e_pos
        np.testing.assert_array_equal(xs[:e_pos].numpy(), e_xs)
        np.testing.assert_array_equal(vals[:e_pos].numpy(), e_vals)
        np.testing.assert_array_equal(new_prev.numpy(), e_prev)
        prev, prev_np = new_prev, e_prev


# -- the entry points on a file ------------------------------------------------

def _clip_file(tmp_path, cfg, n=5):
    """A clip of ``n`` synthetic frames saved as an ``(n, H, W, 3)``
    ``.npy``; returns its path and the flat frames."""
    src = SyntheticSource(cfg, seed=21)
    frames = np.stack([next(src) for _ in range(n)])
    path = str(tmp_path / "clip.npy")
    np.save(path, frames.reshape(n, H, W, 3))
    return path, frames


def _oracle_states(cfg, frames, n_frames, first=0):
    """The base frame and the state after each served frame of a looping
    file source whose frame ``first`` is the base frame (1 where the
    server starts its executor on the source's first frame before
    serving, as the JAX server and broadcast do)."""
    states = [frames[first]]
    for k in range(first + 1, first + n_frames + 1):
        states.append(ref.step_oracle(states[-1], frames[k % len(frames)],
                                      cfg)[0])
    return states


def _run_main(main, argv):
    errors = []

    def run():
        try:
            main(argv)
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, errors


def _connect(port):
    """The port's client on ``port``, once the server listens."""
    for _ in range(2000):
        cli = DeltaStreamClient("127.0.0.1", port, H, W)
        try:
            cli.connect()
            return cli
        except ConnectionRefusedError:
            threading.Event().wait(0.01)
    raise AssertionError(f"nothing listens on {port}")


def _free_ports(k):
    """A port p with p .. p + k - 1 free (as far as binding shows)."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        socks = [socket.socket() for _ in range(k)]
        try:
            for i, s in enumerate(socks):
                s.bind(("127.0.0.1", p + i))
            return p
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError("no free ports")


SERVER_FILE_PATHS = {
    "v1": [],
    "prefetch": ["--prefetch"],
    "tiled_flat_v1": ["--tiled", "--fetch", "flat"],
    "tiled_flat_v3": ["--tiled", "--fetch", "flat", "--wire", "v3"],
    "tiled_tiles_prefetch_v4": ["--tiled", "--fetch", "tiles", "--wire", "v4",
                                "--prefetch"],
}


@pytest.mark.parametrize("path_kind", list(SERVER_FILE_PATHS))
def test_server_main_serves_a_file(path_kind, cfg, tmp_path, monkeypatch,
                                   timed_connections):
    """``server.main --source file --path`` (with ``--prefetch``, tiled v1
    through the segments sender, v3 and v4 through the C encoder), the
    file looped past its end: the client's every state equals a replay
    of the file through ``step_oracle`` from its base frame, the file's
    second frame: under the default ``--calibrate 2`` the server starts
    its executor on the first, as the JAX server does."""
    monkeypatch.setattr(ExecMetrics, "status_line", lambda self, *a: None)
    path, frames = _clip_file(tmp_path, cfg)
    n_frames = 8
    port = _free_ports(1)
    t, errors = _run_main(server_mod.main, [
        "--source", "file", "--path", path, "--frames", str(n_frames),
        "--port", str(port), "--device", "cpu", "--height", str(H),
        "--width", str(W)] + SERVER_FILE_PATHS[path_kind])
    cli = _connect(port)
    states = _oracle_states(cfg, frames, n_frames, first=1)
    np.testing.assert_array_equal(cli.frame, states[0])
    for k in range(1, n_frames + 1):
        np.testing.assert_array_equal(cli.read_frame()[1], states[k])
    with pytest.raises(ConnectionError):
        cli.read_frame()
    cli.close()
    t.join(TIMEOUT)
    assert not t.is_alive() and not errors, errors


@pytest.mark.parametrize("wire_format", ["v1", "v3"])
def test_multiserve_main_serves_a_file(wire_format, cfg, tmp_path,
                                       monkeypatch, timed_connections):
    """``multiserve.main --streams 2 --source file --path``: every stream
    reads the file; each client, admitted at whatever frame it arrived,
    holds from then on the oracle replay's states."""
    monkeypatch.setattr(ExecMetrics, "status_line", lambda self, *a: None)
    path, frames = _clip_file(tmp_path, cfg)
    n_frames = 8
    port = _free_ports(2)
    t, errors = _run_main(multiserve.main, [
        "--streams", "2", "--source", "file", "--path", path, "--frames",
        str(n_frames), "--port", str(port), "--device", "cpu", "--height",
        str(H), "--width", str(W), "--wire", wire_format])
    states = _oracle_states(cfg, frames, n_frames)
    got = [[], []]

    def read(b):
        cli = _connect(port + b)
        got[b].append(cli.frame.copy())
        try:
            while True:
                got[b].append(cli.read_frame()[1].copy())
        except ConnectionError:
            pass
        finally:
            cli.close()

    readers = [threading.Thread(target=read, args=(b,), daemon=True)
               for b in range(2)]
    for r in readers:
        r.start()
    t.join(TIMEOUT)
    for r in readers:
        r.join(TIMEOUT)
    assert not t.is_alive() and not any(r.is_alive() for r in readers)
    assert not errors, errors
    for b in range(2):
        first = next(k for k, s in enumerate(states)
                     if np.array_equal(s, got[b][0]))
        assert len(got[b]) == len(states) - first
        for k, state in enumerate(got[b]):
            np.testing.assert_array_equal(state, states[first + k])
    assert any(np.array_equal(got[b][0], states[0]) for b in range(2))


def _read_to_close(port):
    """Every byte a server sends one raw loopback reader, to its close."""
    for _ in range(2000):
        try:
            sock = socket.create_connection(("127.0.0.1", port),
                                            timeout=TIMEOUT)
            break
        except ConnectionRefusedError:
            threading.Event().wait(0.01)
    else:
        raise AssertionError(f"nothing listens on {port}")
    chunks = []
    with sock:
        while chunk := sock.recv(1 << 16):
            chunks.append(chunk)
    return b"".join(chunks)


@pytest.mark.parametrize("name", ["server", "broadcast"])
def test_base_frame_and_deltas_equal_the_jax_main(name, cfg, tmp_path,
                                                  monkeypatch):
    """The same ``.npy`` clip served by the JAX ``server``/``broadcast``
    main (CPU backend) and by the port's, each to a raw loopback reader:
    the wire bytes are equal, the base frame (the clip's second frame:
    both start their executor on the first before serving, under the
    default ``--calibrate 2``) and every delta after it."""
    for metrics in (ExecMetrics, JaxMetrics):  # no status text overlay
        monkeypatch.setattr(metrics, "status_line", lambda self, *a: None)
    path, frames = _clip_file(tmp_path, cfg)
    argv = ["--source", "file", "--path", path, "--frames", "6",
            "--height", str(H), "--width", str(W)]
    mains = {"server": (jax_server.main, server_mod.main),
             "broadcast": (jax_broadcast.main, broadcast.main)}[name]
    got = []
    for main, extra in zip(mains, ([], ["--device", "cpu"])):
        port = _free_ports(1)
        t, errors = _run_main(main, argv + ["--port", str(port)] + extra)
        got.append(_read_to_close(port))
        t.join(TIMEOUT)
        assert not t.is_alive() and not errors, errors
    jax_wire, port_wire = got
    assert port_wire[:cfg.frame_bytes] == frames[1].tobytes()
    assert len(port_wire) > cfg.frame_bytes + 4 * 6
    assert port_wire == jax_wire


def test_broadcast_main_serves_a_file(cfg, tmp_path, monkeypatch,
                                      timed_connections):
    """``broadcast.main --source file --path --tiled``: the first client's
    states equal the oracle replay of the file from its second frame,
    every frame (the executor starts on the first, as in the JAX
    broadcast)."""
    monkeypatch.setattr(ExecMetrics, "status_line", lambda self, *a: None)
    path, frames = _clip_file(tmp_path, cfg)
    n_frames = 7
    port = _free_ports(1)
    t, errors = _run_main(broadcast.main, [
        "--source", "file", "--path", path, "--frames", str(n_frames),
        "--port", str(port), "--device", "cpu", "--height", str(H),
        "--width", str(W), "--tiled", "--fetch", "tiles"])
    cli = _connect(port)
    states = _oracle_states(cfg, frames, n_frames, first=1)
    np.testing.assert_array_equal(cli.frame, states[0])
    for k in range(1, n_frames + 1):
        np.testing.assert_array_equal(cli.read_frame()[1], states[k])
    cli.close()
    t.join(TIMEOUT)
    assert not t.is_alive() and not errors, errors
