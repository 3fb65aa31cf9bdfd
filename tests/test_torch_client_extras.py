"""The port client's extras on the CPU against the JAX package's client:
``--record`` (the wire bytes it tees equal those the JAX client records
from the same server, and ``ReplayServer`` re-serves them byte-exact),
``--save`` and ``--ppm`` (the same files), ``--aux`` (an aux stream read
to PPM files), and ``--http`` (``make_http_relay``: the viewer page,
``/stream`` and ``/aux`` fetched over ``urllib`` with a timeout). Every
socket has a timeout and every thread is joined with one."""

import os
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from cudavideostream_tpu.runtime import client as jax_client
from cudavideostream_tpu_torch.config import StreamConfig, Visualizer
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.runtime import auxstream
from cudavideostream_tpu_torch.runtime import client as client_mod
from cudavideostream_tpu_torch.runtime.executor import StreamExecutor
from cudavideostream_tpu_torch.runtime.replay import ReplayServer
from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer
from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

H, W = 48, 64
TIMEOUT = 30
N_FRAMES = 5


@pytest.fixture(autouse=True)
def timed_connections(monkeypatch):
    """Every socket opened through ``create_connection`` without a timeout
    (the clients of both packages) gets the test's."""
    real = socket.create_connection

    def create_connection(address, timeout=TIMEOUT, *a, **kw):
        return real(address, timeout, *a, **kw)

    monkeypatch.setattr(socket, "create_connection", create_connection)


def _serve(wire="v1", n_frames=N_FRAMES, seed=6, visualizer=0):
    """A listening port server of a seeded synthetic scene on its own
    thread; returns ``(server, thread, errors)``."""
    cfg = StreamConfig(height=H, width=W, port=0, wire_format=wire,
                       visualizer=Visualizer(visualizer))
    server = DeltaStreamServer(cfg, SyntheticSource(cfg, seed=seed),
                               executor=StreamExecutor(cfg, device="cpu"),
                               verbose=False, overlay_status=False)
    server.listen()
    errors = []

    def run():
        try:
            server.serve(max_frames=n_frames)
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return server, t, errors


def _join(server, t, errors):
    t.join(TIMEOUT)
    server.close()
    assert not t.is_alive() and not errors, errors


def _states(n_frames=N_FRAMES, seed=6):
    cfg = StreamConfig(height=H, width=W)
    src = SyntheticSource(cfg, seed=seed)
    states = [src.base_frame()]
    for _ in range(n_frames):
        states.append(ref.step_oracle(states[-1], next(src), cfg)[0])
    return states


def _run_client(main, port, extra):
    return main(["--port", str(port), "--height", str(H), "--width", str(W)]
                + extra)


@pytest.mark.parametrize("wire", ["v1", "v2", "v3"])
def test_record_equals_the_jax_clients(wire, tmp_path):
    """The same server run twice: the port client's ``--record`` file
    equals the JAX client's, byte for byte."""
    files = {}
    for name, main in (("port", client_mod.main), ("jax", jax_client.main)):
        server, t, errors = _serve(wire)
        files[name] = str(tmp_path / f"{name}.cvs")
        assert _run_client(main, server.port,
                           ["--record", files[name]]) == 0
        _join(server, t, errors)
    port_bytes = open(files["port"], "rb").read()
    assert port_bytes == open(files["jax"], "rb").read()
    assert len(port_bytes) >= H * W * 3


@pytest.mark.parametrize("wire", ["v1", "v3"])
def test_recorded_session_replays_byte_exact(wire, tmp_path):
    """``ReplayServer`` re-serves the port client's recording: a client
    decodes the oracle's states from it, and records the same bytes."""
    server, t, errors = _serve(wire)
    path = str(tmp_path / "s.cvs")
    assert _run_client(client_mod.main, server.port, ["--record", path]) == 0
    _join(server, t, errors)
    replay = ReplayServer(path, H * W * 3, port=0, verbose=False)
    replay.listen()
    rt = threading.Thread(target=replay.serve, daemon=True)
    rt.start()
    again = str(tmp_path / "again.cvs")
    cli = client_mod.DeltaStreamClient("127.0.0.1", replay.port, H, W,
                                       record=again)
    cli.connect()
    got = [cli.frame.copy()]
    try:
        while True:
            got.append(cli.read_frame()[1].copy())
    except ConnectionError:
        pass
    cli.close()
    rt.join(TIMEOUT)
    replay.close()
    assert not rt.is_alive()
    want = _states()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert open(again, "rb").read() == open(path, "rb").read()


@pytest.mark.parametrize("every", [1, 2])
def test_save_and_ppm_equal_the_jax_clients(every, tmp_path, capsys):
    """``--save`` writes the rebuilt frames (the oracle's states) and
    ``--ppm`` every ``--ppm-every``-th frame as a P6 image: the same files
    as the JAX client writes."""
    out = {}
    for name, main in (("port", client_mod.main), ("jax", jax_client.main)):
        d = tmp_path / name
        d.mkdir()
        server, t, errors = _serve()
        assert _run_client(main, server.port, [
            "--save", str(d / "frames.npy"), "--ppm", str(d / "f"),
            "--ppm-every", str(every)]) == 0
        _join(server, t, errors)
        out[name] = d
    names = sorted(os.listdir(out["port"]))
    assert names == sorted(os.listdir(out["jax"]))
    assert len([n for n in names if n.endswith(".ppm")]) == len(
        range(0, N_FRAMES, every))
    for n in names:
        assert (out["port"] / n).read_bytes() == (out["jax"] / n).read_bytes()
    saved = np.load(out["port"] / "frames.npy")
    np.testing.assert_array_equal(saved, np.stack(_states()[1:]))
    first = (out["port"] / "f_000001.ppm").read_bytes()
    header = f"P6\n{W} {H}\n255\n".encode()
    assert first.startswith(header)
    img = np.frombuffer(first[len(header):], np.uint8).reshape(H, W, 3)
    np.testing.assert_array_equal(img[:, :, ::-1].reshape(-1), saved[0])
    assert "saved 5 frames" in capsys.readouterr().out


def test_client_aux_reads_the_side_stream(tmp_path, capsys):
    """``client --aux --ppm``: the aux frames of a sink, written as PPM
    images named by their index."""
    sink = auxstream.AuxStreamSink(H, W, drop=False)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, H * W * 3, dtype=np.uint8)
              for _ in range(3)]
    result = []
    t = threading.Thread(target=lambda: result.append(_run_client(
        client_mod.main, sink.port, ["--aux", "--frames", "3", "--ppm",
                                     str(tmp_path / "aux"), "--ppm-every",
                                     "1"])), daemon=True)
    t.start()
    deadline = threading.Event()
    for _ in range(int(TIMEOUT / 0.01)):
        if sink.n_clients:
            break
        deadline.wait(0.01)
    for k, f in enumerate(frames):
        sink.push(7 + k, f)
    t.join(TIMEOUT)
    sink.close()
    assert not t.is_alive() and result == [0]
    for k, f in enumerate(frames):
        data = (tmp_path / f"aux_{7 + k:06d}.ppm").read_bytes()
        img = np.frombuffer(data[-H * W * 3:], np.uint8).reshape(H, W, 3)
        np.testing.assert_array_equal(img[:, :, ::-1].reshape(-1), f)
    assert "received 3 aux frames" in capsys.readouterr().out


def _relay(port, aux_port=None):
    srv = client_mod.make_http_relay(0, "127.0.0.1", port, H, W,
                                     aux_port=aux_port, timeout=TIMEOUT,
                                     listen_host="127.0.0.1")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, t):
    srv.shutdown()
    srv.server_close()
    t.join(TIMEOUT)
    assert not t.is_alive()


@pytest.mark.parametrize("aux", [False, True], ids=["stream", "aux_panel"])
def test_http_relay_serves_the_viewer(aux):
    """``/`` is ``examples/viewer.html`` with this stream's geometry (and
    the aux panel on with ``aux_port``); an unknown path is a 404."""
    srv, t, url = _relay(1, aux_port=2 if aux else None)
    try:
        with urllib.request.urlopen(url + "/", timeout=TIMEOUT) as r:
            html = r.read()
        assert html == client_mod.VIEWER.read_bytes().replace(
            b'id="w" value="480"', f'id="w" value="{W}"'.encode()
        ).replace(b'id="h" value="270"', f'id="h" value="{H}"'.encode()
                  ).replace(*((b"AUX_ENABLED = false", b"AUX_ENABLED = true")
                              if aux else (b"", b"")))
        assert (b"AUX_ENABLED = true" in html) == aux
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/nothing", timeout=TIMEOUT)
        assert e.value.code == 404
        e.value.close()
    finally:
        _stop(srv, t)


@pytest.mark.parametrize("wire", ["v1", "v3"])
def test_http_relay_pipes_the_stream(wire, tmp_path):
    """``/stream`` relays the server's raw wire bytes: they equal a
    recording of the same server's stream."""
    server, st, errors = _serve(wire)
    path = str(tmp_path / "direct.cvs")
    assert _run_client(client_mod.main, server.port, ["--record", path]) == 0
    _join(server, st, errors)
    server, st, errors = _serve(wire)
    srv, t, url = _relay(server.port)
    try:
        with urllib.request.urlopen(url + "/stream", timeout=TIMEOUT) as r:
            relayed = r.read()
    finally:
        _stop(srv, t)
    _join(server, st, errors)
    assert relayed == open(path, "rb").read()


def test_http_relay_pipes_the_aux_stream():
    """``/aux`` relays the aux side stream's bytes: its header and
    frames."""
    sink = auxstream.AuxStreamSink(H, W, drop=False)
    srv, t, url = _relay(1, aux_port=sink.port)
    frame = np.arange(H * W * 3, dtype=np.uint32).astype(np.uint8)
    try:
        with urllib.request.urlopen(url + "/aux", timeout=TIMEOUT) as r:
            for _ in range(int(TIMEOUT / 0.01)):
                if sink.n_clients:
                    break
                threading.Event().wait(0.01)
            sink.push(4, frame)
            head = r.read(12 + 8 + frame.size)
            sink.close()
    finally:
        _stop(srv, t)
    assert head[:4] == b"CVSX"
    assert np.frombuffer(head[4:12], "<u4").tolist() == [H, W]
    assert np.frombuffer(head[12:20], "<u4").tolist() == [4, frame.size]
    np.testing.assert_array_equal(np.frombuffer(head[20:], np.uint8), frame)


def test_http_relay_reports_a_dead_upstream():
    """An upstream that does not listen: a 502, not a hang."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv, t, url = _relay(port)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/stream", timeout=TIMEOUT)
        assert e.value.code == 502
        e.value.close()
    finally:
        _stop(srv, t)
