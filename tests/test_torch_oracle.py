"""The port's oracle executor (``runtime/oracle_executor.py``, ``server
--backend oracle``) on the CPU against the JAX package's
``OracleExecutor`` and against the port's device executor: the same
payloads, aux frames, overflow contract and resync; and ``server.main
--backend oracle`` served to a loopback client, byte-exact against
``step_oracle``. Every socket has a timeout and every thread is joined
with one."""

import dataclasses
import functools
import socket
import threading

import numpy as np
import pytest

from cudavideostream_tpu.config import PayloadOverflowError as JaxOverflow
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.config import Visualizer as JaxVisualizer
from cudavideostream_tpu.runtime.oracle_executor import \
    OracleExecutor as JaxOracle
from cudavideostream_tpu_torch.config import (
    PayloadOverflowError,
    StreamConfig,
    Visualizer,
)
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.runtime import server as server_mod
from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
from cudavideostream_tpu_torch.runtime.executor import (
    ExecMetrics,
    StreamExecutor,
)
from cudavideostream_tpu_torch.runtime.oracle_executor import OracleExecutor
from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

H, W = 48, 64
TIMEOUT = 30
TEXTS = ["", "AB", "AB", "FPS: 3", ""]


@pytest.fixture(autouse=True)
def timed_connections(monkeypatch):
    monkeypatch.setattr(socket, "create_connection", functools.partial(
        socket.create_connection, timeout=TIMEOUT))


def _cfg(**kw):
    return StreamConfig(height=H, width=W, overlay_scale=4, port=0, **kw)


def jax_config(cfg) -> JaxConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JaxConfig)
          if f.name not in ("visualizer", "compaction")}
    return JaxConfig(visualizer=JaxVisualizer(cfg.visualizer.value), **kw)


def _frames(seed, n=len(TEXTS)):
    src = SyntheticSource(_cfg(), seed=seed)
    return src.base_frame(), [next(src) for _ in range(n)]


CASES = {"plain": {}, "heatmap": dict(visualizer=Visualizer.HEATMAP),
         "red_overlap": dict(visualizer=Visualizer.RED_OVERLAP),
         "binarize_denoise": dict(visualizer=Visualizer.BINARIZE,
                                  noise_filter=True),
         "no_negfeed": dict(negative_feedback=False)}


@pytest.mark.parametrize("case", list(CASES))
def test_oracle_matches_jax_and_device(case):
    """Per frame, ``(pos, xs, vals, aux)`` equal to the JAX oracle's and to
    the port's device executor's, and the states equal."""
    cfg = _cfg(**CASES[case])
    base, frames = _frames(seed=len(case))
    ours, theirs = OracleExecutor(cfg), JaxOracle(jax_config(cfg))
    device = StreamExecutor(cfg, device="cpu")
    for ex in (ours, theirs, device):
        np.testing.assert_array_equal(ex.start(base), base)
    for frame, text in zip(frames, TEXTS):
        got = ours.process(frame, text=text)
        want = theirs.process(frame, text=text)
        dev = device.process(frame, text=text)
        assert got[0] == want[0] == dev[0]
        for g, w, d in zip(got[1:], want[1:], dev[1:]):
            if g is None:
                assert w is None and d is None
                continue
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, d)
        np.testing.assert_array_equal(ours.resync(), theirs.resync())
        np.testing.assert_array_equal(ours.resync(), device.resync())
    assert ours.metrics.total_frames == len(frames)
    assert ours.flush() is None


def test_oracle_overflow_and_refusals():
    """Past the capacity: ``PayloadOverflowError`` from both oracles, the
    state already past the frame (the resync frame); a base frame of
    another size and a step before ``start`` raise, as in the JAX one."""
    cfg = _cfg(payload_capacity=5)
    base, frames = _frames(seed=2)
    ours, theirs = OracleExecutor(cfg), JaxOracle(jax_config(cfg))
    with pytest.raises(RuntimeError, match="start"):
        ours.process(frames[0])
    with pytest.raises(RuntimeError, match="resync"):
        ours.resync()
    with pytest.raises(ValueError, match="size mismatch"):
        ours.start(base[:-3])
    ours.start(base)
    theirs.start(base)
    with pytest.raises(PayloadOverflowError):
        ours.process(frames[0])
    with pytest.raises(JaxOverflow):
        theirs.process(frames[0])
    want = ref.step_oracle(base, frames[0], cfg)[0]
    np.testing.assert_array_equal(ours.resync(), want)
    np.testing.assert_array_equal(theirs.resync(), want)


@pytest.mark.parametrize("wire", ["v1", "v3"])
def test_server_main_backend_oracle(wire, monkeypatch):
    """``server.main --backend oracle``: the client's every state equals a
    replay of the synthetic source through ``step_oracle``."""
    monkeypatch.setattr(ExecMetrics, "status_line", lambda self, *a: None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n_frames = 4
    errors = []

    def run():
        try:
            server_mod.main(["--backend", "oracle", "--height", str(H),
                             "--width", str(W), "--frames", str(n_frames),
                             "--port", str(port), "--seed", "3",
                             "--wire", wire])
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    for _ in range(2000):
        cli = DeltaStreamClient("127.0.0.1", port, H, W)
        try:
            cli.connect()
            break
        except ConnectionRefusedError:
            threading.Event().wait(0.01)
    src = SyntheticSource(StreamConfig(height=H, width=W), seed=3)
    state = src.base_frame()
    np.testing.assert_array_equal(cli.frame, state)
    for _ in range(n_frames):
        state = ref.step_oracle(state, next(src), StreamConfig(
            height=H, width=W))[0]
        np.testing.assert_array_equal(cli.read_frame()[1], state)
    with pytest.raises(ConnectionError):
        cli.read_frame()
    cli.close()
    t.join(TIMEOUT)
    assert not t.is_alive() and not errors, errors


@pytest.mark.parametrize("flags,msg", [
    (["--threshold-map", "MAP"], "not supported by --backend oracle"),
    (["--save-state", "s.npz"], "checkpointable executor"),
    (["--link-cache", "l.json"], "needs a device StreamExecutor"),
    (["--tiled", "--land-batch", "2"], "exclusive with --pipelined"),
], ids=["threshold_map", "save_state", "link_cache", "land_batch"])
def test_oracle_refusals_match_jax(flags, msg, tmp_path, capsys):
    """The JAX server's refusals of ``--backend oracle``, as usage
    errors."""
    path = tmp_path / "map.npy"
    np.save(path, np.full((H, W), 20, np.uint8))
    flags = [str(path) if f == "MAP" else f for f in flags]
    with pytest.raises(SystemExit):
        server_mod.setup(["--backend", "oracle", "--height", str(H),
                          "--width", str(W)] + flags)
    assert msg in capsys.readouterr().err


def test_oracle_skips_the_calibration():
    """``--calibrate`` (default 2) is a no-op for the oracle, as in the JAX
    server: it has no copies to time."""
    cfg, ex, _, args = server_mod.setup(["--backend", "oracle", "--height",
                                      str(H), "--width", str(W)])
    assert args.calibrate == 2 and isinstance(ex, OracleExecutor)
    assert not hasattr(ex, "calibrate_link")
