"""The port's host runtime: sources, wire v1, the executor and the full TCP
loopback (port server to port client, and port server to the JAX
package's client), byte-exact against an oracle replay; plus the import
isolation of the port."""

import ast
import dataclasses
import pathlib
import socket
import threading

import numpy as np
import pytest

from cudavideostream_tpu.runtime import sources as jax_sources
from cudavideostream_tpu.runtime import wire as jax_wire
from cudavideostream_tpu.runtime.client import DeltaStreamClient as JaxClient
from cudavideostream_tpu_torch.config import PayloadOverflowError, StreamConfig
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.runtime import client as client_mod
from cudavideostream_tpu_torch.runtime import server as server_mod
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
from cudavideostream_tpu_torch.runtime.executor import StreamExecutor
from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer
from cudavideostream_tpu_torch.runtime.sources import (
    SyntheticSource,
    make_source,
)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def cfg():
    return StreamConfig(height=48, width=64, overlay_scale=4, port=0)


def _serve_in_thread(server, n_frames):
    errors = []

    def run():
        try:
            server.serve(max_frames=n_frames)
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    server.listen()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, errors


def _oracle_states(cfg, seed, n_frames):
    replay = SyntheticSource(cfg, seed=seed)
    prev = next(replay).copy()
    states = [prev]
    for _ in range(n_frames):
        prev = ref.step_oracle(prev, next(replay), cfg)[0]
        states.append(prev)
    return states


@pytest.mark.parametrize("client_kind", ["port", "jax"])
def test_loopback_byte_exact(cfg, client_kind):
    """Over a real socket: the client's reconstruction equals an oracle
    replay of the same source, frame for frame. The JAX package's client
    decoding the port's server proves the wire is unchanged."""
    n_frames = 5
    server = DeltaStreamServer(cfg, SyntheticSource(cfg, seed=3),
                               verbose=False, overlay_status=False,
                               device="cpu")
    t, errors = _serve_in_thread(server, n_frames)
    if client_kind == "port":
        cli = DeltaStreamClient("127.0.0.1", server.port, cfg.height,
                                cfg.width)
    else:
        cli = JaxClient("127.0.0.1", server.port, cfg.height, cfg.width,
                        wire_format="v1")
    cli.connect()
    states = _oracle_states(cfg, 3, n_frames)
    np.testing.assert_array_equal(cli.frame, states[0])
    positions = []
    for k in range(n_frames):
        pos, recon = cli.read_frame()
        positions.append(pos)
        np.testing.assert_array_equal(recon, states[k + 1])
    cli.close()
    t.join(timeout=30)
    server.close()
    assert not t.is_alive() and not errors
    assert positions[0] > 0
    # the executor's state is the client's reconstruction
    np.testing.assert_array_equal(server.executor.resync(), states[-1])


def test_server_main_and_client_main(capsys):
    """The command-line entry points, end to end on the CPU."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = ["--height", "48", "--width", "64", "--frames", "3",
            "--port", str(port), "--device", "cpu"]
    errors = []

    def run():
        try:
            server_mod.main(args)
        except BaseException as e:
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    for _ in range(200):  # until the server listens
        try:
            rc = client_mod.main(["--port", str(port), "--height", "48",
                                  "--width", "64", "--frames", "3"])
            break
        except ConnectionRefusedError:
            threading.Event().wait(0.05)
    t.join(timeout=30)
    assert rc == 0 and not errors and not t.is_alive()
    assert "decoded 3 frames" in capsys.readouterr().out


def test_capacity_overflow_is_fatal_on_v1(cfg):
    """A frame that changes more bytes than --capacity raises instead of
    truncating (a v1 client cannot be resynced)."""
    cfg = dataclasses.replace(cfg, payload_capacity=64)
    ex = StreamExecutor(cfg, device="cpu")
    ex.start(np.zeros(cfg.frame_bytes, np.uint8))
    with pytest.raises(PayloadOverflowError):
        ex.process(np.full(cfg.frame_bytes, 200, np.uint8))
    # the state has advanced past the frame, as in the JAX executor
    assert (ex.resync() == 200).all()

    server = DeltaStreamServer(cfg, SyntheticSource(cfg, seed=1),
                               verbose=False, overlay_status=False,
                               device="cpu")
    t, errors = _serve_in_thread(server, 3)
    cli = DeltaStreamClient("127.0.0.1", server.port, cfg.height, cfg.width)
    cli.connect()
    with pytest.raises(ConnectionError):
        cli.read_frame()
    cli.close()
    t.join(timeout=30)
    server.close()
    assert len(errors) == 1 and isinstance(errors[0], PayloadOverflowError)


def test_executor_requires_start(cfg):
    ex = StreamExecutor(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="start"):
        ex.process(np.zeros(cfg.frame_bytes, np.uint8))


def test_server_refuses_other_wires(cfg):
    for w in ("v2", "v3", "v4"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            DeltaStreamServer(dataclasses.replace(cfg, wire_format=w),
                              SyntheticSource(cfg), device="cpu")


def test_synthetic_source_matches_jax(cfg):
    from cudavideostream_tpu.config import StreamConfig as JaxConfig

    jcfg = JaxConfig(height=cfg.height, width=cfg.width)
    a = SyntheticSource(cfg, seed=7)
    b = jax_sources.SyntheticSource(jcfg, seed=7)
    for _ in range(4):
        np.testing.assert_array_equal(next(a), next(b))
    with pytest.raises(NotImplementedError, match="ROADMAP.md M16"):
        make_source("file", cfg)
    with pytest.raises(ValueError):
        make_source("webcam9000", cfg)


def test_wire_v1_bytes_match_jax(rng):
    xs = np.sort(rng.choice(10_000, 300, replace=False)).astype(np.int32)
    vals = rng.integers(1, 255, 300, dtype=np.uint8)
    buf = wire.pack_payload(300, xs, vals)
    assert buf == jax_wire.pack_payload(300, xs, vals)
    pos, x2, v2, used = wire.unpack_payload(buf + b"tail")
    assert pos == 300 and used == len(buf)
    np.testing.assert_array_equal(x2, xs)
    np.testing.assert_array_equal(v2, vals)
    with pytest.raises(ValueError):
        wire.unpack_payload(buf[:-1])
    chunks = iter([buf[i:i + 7] for i in range(0, len(buf), 7)])
    pending = bytearray()

    def read(n):
        while len(pending) < n:
            pending.extend(next(chunks))
        out = bytes(pending[:n])
        del pending[:n]
        return out

    pos, x3, v3 = wire.read_payload(read)
    assert pos == 300
    np.testing.assert_array_equal(x3, xs)
    np.testing.assert_array_equal(v3, vals)


def test_client_accumulates_repeated_indices(cfg):
    """The scatter is a wrap-add that accumulates repeated indices, as
    the reference client's loop does."""
    a, b = socket.socketpair()
    with a, b:
        base = np.full(cfg.frame_bytes, 250, np.uint8)
        cli = DeltaStreamClient(height=cfg.height, width=cfg.width)
        cli.sock = b
        cli.frame = base.copy()
        a.sendall(wire.pack_payload(3, np.array([5, 5, 9], np.int32),
                                    np.array([3, 4, 10], np.uint8)))
        pos, frame = cli.read_frame()
    assert pos == 3
    assert frame[5] == 1 and frame[9] == 4 and frame[0] == 250


def _port_python_files():
    files = sorted((REPO / "cudavideostream_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


FORBIDDEN = {"jax", "jaxlib", "cudavideostream_tpu"}


def test_port_imports_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports jax, jaxlib
    or the JAX package (whose name is a prefix of the port's: names are
    compared exactly)."""
    files = _port_python_files()
    assert len(files) > 10 and files[-1].exists()
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
