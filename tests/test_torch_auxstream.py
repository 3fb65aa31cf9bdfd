"""The port's live aux stream (``runtime/auxstream.py``) on the CPU: its
sink read by the JAX package's ``AuxStreamClient`` and the JAX sink read by
the port's client, frame-exact under ``drop=False``; the latest-wins
mailbox; a viewer that leaves; and ``server.main --aux-port`` with
``--visualizer 1`` and ``5``, whose aux frames equal the step's. Every
socket has a timeout and every thread is joined with one."""

import functools
import socket
import threading
import time

import numpy as np
import pytest

from cudavideostream_tpu.runtime import auxstream as jax_aux
from cudavideostream_tpu_torch.config import StreamConfig, Visualizer
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.runtime import auxstream
from cudavideostream_tpu_torch.runtime import server as server_mod
from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
from cudavideostream_tpu_torch.runtime.executor import ExecMetrics
from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

H, W = 12, 20
TIMEOUT = 30


@pytest.fixture(autouse=True)
def timed_connections(monkeypatch):
    monkeypatch.setattr(socket, "create_connection", functools.partial(
        socket.create_connection, timeout=TIMEOUT))


def _aux_frames(n, seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, h * w * 3, dtype=np.uint8) for _ in range(n)]


def _wait(cond, what):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


SINKS = {"port_sink_jax_client": (auxstream.AuxStreamSink,
                                  jax_aux.AuxStreamClient),
         "jax_sink_port_client": (jax_aux.AuxStreamSink,
                                  auxstream.AuxStreamClient),
         "port_sink_port_client": (auxstream.AuxStreamSink,
                                   auxstream.AuxStreamClient)}


@pytest.mark.parametrize("pair", list(SINKS))
def test_frames_cross_between_packages(pair):
    """``drop=False``: the header's geometry and every pushed frame, with
    its index, in order; the wire is the same ``CVSX`` framing."""
    sink_cls, client_cls = SINKS[pair]
    assert auxstream.MAGIC == jax_aux.MAGIC == b"CVSX"
    sink = sink_cls(H, W, drop=False)
    cli = client_cls("127.0.0.1", sink.port)
    try:
        cli.connect()
        assert (cli.height, cli.width) == (H, W)
        _wait(lambda: sink.n_clients == 1, "the viewer")
        frames = _aux_frames(6, seed=len(pair))
        for k, f in enumerate(frames):
            sink.push(10 + k, f)
        for k, f in enumerate(frames):
            idx, got = cli.read_frame()
            assert idx == 10 + k
            np.testing.assert_array_equal(got, f)
    finally:
        cli.close()
        sink.close()


def test_latest_frame_wins():
    """Under ``drop=True`` a viewer that does not read loses frames: the
    last frame pushed always arrives, and no frame arrives twice or out
    of order."""
    sink = auxstream.AuxStreamSink(64, 64, drop=True)
    cli = auxstream.AuxStreamClient("127.0.0.1", sink.port)
    try:
        cli.connect()
        _wait(lambda: sink.n_clients == 1, "the viewer")
        frames = _aux_frames(40, h=64, w=64)
        for k, f in enumerate(frames):
            sink.push(k, f)
        seen = []
        while not seen or seen[-1] != len(frames) - 1:
            idx, got = cli.read_frame()
            np.testing.assert_array_equal(got, frames[idx])
            seen.append(idx)
        assert seen == sorted(set(seen))
    finally:
        cli.close()
        sink.close()


def test_a_viewer_that_leaves_is_dropped():
    """``push`` never raises for a dead viewer; it is detached, and the
    other viewer goes on receiving."""
    sink = auxstream.AuxStreamSink(H, W, drop=False)
    a = auxstream.AuxStreamClient("127.0.0.1", sink.port)
    b = auxstream.AuxStreamClient("127.0.0.1", sink.port)
    try:
        a.connect()
        b.connect()
        _wait(lambda: sink.n_clients == 2, "two viewers")
        a.close()
        frames = _aux_frames(30)
        for k, f in enumerate(frames):
            sink.push(k, f)
            idx, got = b.read_frame()
            assert idx == k
            np.testing.assert_array_equal(got, f)
        _wait(lambda: sink.n_clients == 1, "the dead viewer to detach")
    finally:
        b.close()
        sink.close()
    assert not sink._accept_thread.is_alive()


def test_client_refuses_another_stream_and_times_out():
    """A server that is no aux stream: wrong magic raises; one that never
    sends: the read gives up after the client's timeout."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)
    port = srv.getsockname()[1]
    conns = []

    def accept(payload):
        conn, _ = srv.accept()
        conns.append(conn)
        if payload:
            conn.sendall(payload)

    try:
        t = threading.Thread(target=accept, args=(b"CVSY" + bytes(8),),
                             daemon=True)
        t.start()
        with pytest.raises(ValueError, match="not an aux stream"):
            auxstream.AuxStreamClient("127.0.0.1", port).connect()
        t.join(TIMEOUT)
        t = threading.Thread(target=accept, args=(b"",), daemon=True)
        t.start()
        cli = auxstream.AuxStreamClient("127.0.0.1", port, timeout=0.3)
        with pytest.raises(socket.timeout):
            cli.connect()
        cli.close()
        t.join(TIMEOUT)
    finally:
        for c in conns:
            c.close()
        srv.close()


@pytest.mark.parametrize("vis", [1, 5], ids=["heatmap", "binarize"])
def test_server_main_aux_port(vis, monkeypatch):
    """``server.main --aux-port --visualizer``: a viewer attached before
    the first frame receives aux frames equal to ``step_oracle``'s for
    those frames (the sink is latest-wins, so some may be skipped), while
    the delta stream stays byte-exact from the source's second frame (the
    server starts its executor on the first, as the JAX server does)."""
    monkeypatch.setattr(ExecMetrics, "status_line", lambda self, *a: None)
    h, w = 48, 64
    cfg = StreamConfig(height=h, width=w, visualizer=Visualizer(vis))
    made = {}
    real_sink = server_mod.AuxStreamSink

    def sink(*a, **kw):
        made["sink"] = real_sink(*a, drop=False, **kw)
        return made["sink"]

    monkeypatch.setattr(server_mod, "AuxStreamSink", sink)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n_frames = 4
    errors = []

    def run():
        try:
            server_mod.main(["--device", "cpu", "--height", str(h), "--width",
                             str(w), "--frames", str(n_frames), "--port",
                             str(port), "--seed", "5", "--visualizer",
                             str(vis), "--aux-port", "0"])
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _wait(lambda: "sink" in made or errors, "the aux sink")
    assert not errors, errors
    aux = auxstream.AuxStreamClient("127.0.0.1", made["sink"].port)
    aux.connect()
    _wait(lambda: made["sink"].n_clients == 1, "the viewer")
    for _ in range(2000):
        cli = DeltaStreamClient("127.0.0.1", port, h, w)
        try:
            cli.connect()
            break
        except ConnectionRefusedError:
            threading.Event().wait(0.01)
    src = SyntheticSource(cfg, seed=5)
    src.base_frame()  # the frame the server's executor started on
    state = src.base_frame()
    np.testing.assert_array_equal(cli.frame, state)
    want_aux = []
    for _ in range(n_frames):
        state, _, _, _, a = ref.step_oracle(state, next(src), cfg)
        want_aux.append(a)
        np.testing.assert_array_equal(cli.read_frame()[1], state)
    for k in range(n_frames):
        idx, got = aux.read_frame()
        assert idx == k
        np.testing.assert_array_equal(got, want_aux[k])
    cli.close()
    aux.close()
    t.join(TIMEOUT)
    assert not t.is_alive() and not errors, errors


def test_server_main_aux_port_needs_a_visualizer(capsys):
    """The JAX server's refusal: no visualizer, no aux frame to serve."""
    with pytest.raises(SystemExit):
        server_mod.main(["--device", "cpu", "--height", "48", "--width",
                         "64", "--aux-port", "0", "--frames", "1"])
    assert "--aux-port needs --visualizer" in capsys.readouterr().err
