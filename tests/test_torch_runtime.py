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

from conftest import ScriptedSource
from cudavideostream_tpu.runtime import sources as jax_sources
from cudavideostream_tpu.runtime.executor import TiledLander as JaxLander
from cudavideostream_tpu.runtime import wire as jax_wire
from cudavideostream_tpu.runtime.client import DeltaStreamClient as JaxClient
from cudavideostream_tpu_torch.config import PayloadOverflowError, StreamConfig
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.runtime import client as client_mod
from cudavideostream_tpu_torch.runtime import server as server_mod
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
from cudavideostream_tpu_torch.runtime.executor import (
    BatchedLandExecutor,
    PipelinedExecutor,
    StreamExecutor,
    TiledLander,
)
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
    """Wires v1 to v4 are ported (v4 since ROADMAP M8); any other name is
    refused by the config."""
    for w in ("v1", "v2", "v3", "v4"):
        DeltaStreamServer(dataclasses.replace(cfg, wire_format=w),
                          SyntheticSource(cfg), device="cpu")
    with pytest.raises(ValueError, match="wire_format"):
        dataclasses.replace(cfg, wire_format="v5")


def test_synthetic_source_matches_jax(cfg):
    from cudavideostream_tpu.config import StreamConfig as JaxConfig

    jcfg = JaxConfig(height=cfg.height, width=cfg.width)
    a = SyntheticSource(cfg, seed=7)
    b = jax_sources.SyntheticSource(jcfg, seed=7)
    for _ in range(4):
        np.testing.assert_array_equal(next(a), next(b))
    with pytest.raises(ValueError, match="needs --path"):
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
    rel = {str(f.relative_to(REPO)) for f in files}
    # the modules of the tiled, visualizer and multi-stream slices are in
    # the scan
    for mod in ("ops/logcompact.py", "runtime/wire.py", "runtime/executor.py",
                "runtime/server.py", "runtime/client.py",
                "models/pipeline.py", "kernels/build.py", "ops/filters.py",
                "ops/hist.py", "ops/convolve.py", "models/variants.py",
                "models/batched.py", "runtime/multiserve.py",
                "runtime/broadcast.py", "runtime/replay.py",
                "parallel/__init__.py", "parallel/mesh.py",
                "parallel/halo_conv.py", "parallel/sharded.py",
                "runtime/sharded_executor.py", "runtime/sources.py",
                "native/__init__.py", "native/build.py", "bench.py",
                "utils/timing.py", "utils/profiling.py", "utils/png.py",
                "utils/shapes.py", "examples/stream_demo.py",
                "examples/make_artifacts.py",
                "examples/classical_heatmap.py", "kernel_table.py",
                "loopback.py", "loopback_sweep.py"):
        assert f"cudavideostream_tpu_torch/{mod}" in rel, mod
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



# -- the JAX package's command lines (ROADMAP.md fault 3.1) ---------------

def _jax_options(name):
    """``(option, kwargs)`` of every ``add_argument`` call in the JAX
    ``runtime/<name>.py:main``, found by an ``ast`` scan, with ``type``,
    ``default``, ``choices`` and ``action`` evaluated in that module."""
    import importlib

    path = REPO / "cudavideostream_tpu" / "runtime" / f"{name}.py"
    namespace = vars(importlib.import_module(
        f"cudavideostream_tpu.runtime.{name}"))
    main = next(node for node in ast.parse(path.read_text()).body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    found = []
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: eval(compile(ast.Expression(k.value), str(path),
                                      "eval"), namespace)
                  for k in node.keywords
                  if k.arg in ("type", "default", "choices", "action")}
            found.append((node.args[0].value, kw))
    return found


def _option_values(option, kw, tmp_path):
    """The values to try an option with: every choice, else its default
    and one other value."""
    if kw.get("action") == "store_true":
        return [[]]
    if "choices" in kw:
        return [[str(c)] for c in kw["choices"]]
    if option == "--threshold-map":
        path = tmp_path / "map.npy"
        np.save(path, np.full((48, 64), 20, np.uint8))
        return [[str(path)]]
    if option == "--mesh":
        return [["1,1"]]
    typ = kw.get("type", str)
    other = {int: "1", float: "1.5", str: "x"}[typ]
    default = kw.get("default")
    return [[str(v)] for v in dict.fromkeys([default, other]) if v is not None]


# flags an option needs beside it for the JAX server's own combination
# checks to pass
_CONTEXT = {"--fetch": ["--tiled"], "--bitmask": ["--tiled"],
            "--maskonly": ["--tiled", "--fetch", "mask"],
            "--land-batch": ["--tiled"]}


@pytest.mark.parametrize("name", ["server", "client", "multiserve",
                                  "broadcast", "replay"])
def test_port_takes_every_jax_option(name, tmp_path):
    """Each option of the JAX entry point's command line, with each of its
    choices: the port's parser accepts it (every part is ported: a
    ``NotImplementedError`` would have to name the ``ROADMAP.md`` item
    that ports it); never a usage error. ``--no-pair-lanes`` is a
    documented no-op and ``--calibrate 0`` turns the calibration off;
    ``--calibrate`` takes the JAX default of 2."""
    import importlib
    import re

    module = importlib.import_module(
        f"cudavideostream_tpu_torch.runtime.{name}")
    base = {"server": ["--device", "cpu", "--height", "48", "--width", "64"],
            "client": [], "multiserve": ["--device", "cpu"],
            "broadcast": ["--device", "cpu"],
            "replay": [str(tmp_path / "session.cvs")]}[name]
    options = _jax_options(name)
    assert len(options) >= {"server": 30, "client": 11, "multiserve": 17,
                            "broadcast": 15, "replay": 8}[name]
    bad, refused = [], 0
    for option, kw in options:
        if not option.startswith("--"):
            continue  # the replay path, given in base
        for value in _option_values(option, kw, tmp_path):
            argv = base + _CONTEXT.get(option, []) + [option, *value]
            try:
                module.parse_args(argv)
            except NotImplementedError as e:
                if not re.search(r"ROADMAP\.md M\d+", str(e)):
                    bad.append((argv, f"names no item: {e}"))
                refused += 1
            except SystemExit:
                bad.append((argv, "usage error"))
    assert not bad, bad
    assert not refused
    if name in ("server", "broadcast"):
        assert module.parse_args(base + ["--calibrate", "0"]).calibrate == 0
        assert module.parse_args(base).calibrate == 2
    if name in ("server", "multiserve"):
        # --mesh is served: the sharded pipeline over a (1, 1) mesh
        assert module.parse_args(base + ["--mesh", "1,1"]).mesh == (1, 1)
    if name == "server":
        cfg, ex, _, _ = server_mod.setup(base + ["--mesh", "1,1"])
        assert type(ex).__name__ == "ShardedStreamExecutor"
        cfg = server_mod.setup(base + ["--no-pair-lanes"])[0]
        assert cfg.pair_lanes is False
        for backend in ("sort", "host"):
            cfg, ex, _, _ = server_mod.setup(base + ["--compaction",
                                                     backend])
            assert cfg.compaction.value == backend
            assert type(ex).__name__ == "StreamExecutor"
        cfg, ex, _, _ = server_mod.setup(base + ["--backend", "oracle"])
        assert type(ex).__name__ == "OracleExecutor"

# -- the tiled slice: tiled payloads, wire v2/v3, the pipelined executor --

def _client(kind, port, cfg):
    if kind == "port":
        return DeltaStreamClient("127.0.0.1", port, cfg.height, cfg.width)
    return JaxClient("127.0.0.1", port, cfg.height, cfg.width,
                     wire_format="auto")


def _drain(cli):
    """Every (pos, state copy) the client decodes until the server closes."""
    got = []
    try:
        while True:
            pos, recon = cli.read_frame()
            got.append((pos, recon.copy()))
    except ConnectionError:
        pass
    finally:
        cli.close()
    return got


@pytest.mark.parametrize("client_kind", ["port", "jax"])
@pytest.mark.parametrize("wire_format", ["v1", "v2"])
@pytest.mark.parametrize("fetch", ["tiles", "flat", "auto"])
def test_tiled_loopback_byte_exact(cfg, fetch, wire_format, client_kind):
    """The tiled payload over a real socket, in each landing flavor, to
    both clients (wire auto): the reconstruction equals an oracle replay
    every frame."""
    cfg = dataclasses.replace(cfg, tiled_payload=True, fetch_mode=fetch,
                              wire_format=wire_format)
    n_frames = 5
    server = DeltaStreamServer(cfg, SyntheticSource(cfg, seed=3),
                               verbose=False, overlay_status=False,
                               device="cpu")
    t, errors = _serve_in_thread(server, n_frames)
    cli = _client(client_kind, server.port, cfg)
    cli.connect()
    states = _oracle_states(cfg, 3, n_frames)
    np.testing.assert_array_equal(cli.frame, states[0])
    got = _drain(cli)
    t.join(timeout=30)
    server.close()
    assert not t.is_alive() and not errors
    assert len(got) == n_frames and got[0][0] > 0
    for (_, recon), want in zip(got, states[1:]):
        np.testing.assert_array_equal(recon, want)
    counts = server.executor.fetch_counts
    assert sum(counts.values()) == n_frames
    if fetch != "auto":
        assert counts[fetch] == n_frames
    else:  # the warm-up takes each flavor twice
        assert counts["tiles"] >= 2 and counts["flat"] >= 2


@pytest.mark.parametrize("client_kind", ["port", "jax"])
@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "flat"])
def test_pipelined_v3_loopback_byte_exact(cfg, tiled, client_kind):
    """The pipelined executor lags a frame and flushes the last one; under
    wire v3 every frame still decodes to the oracle state, in order."""
    cfg = dataclasses.replace(cfg, tiled_payload=tiled, wire_format="v3")
    n_frames = 6
    server = DeltaStreamServer(cfg, SyntheticSource(cfg, seed=4),
                               executor=PipelinedExecutor(cfg, device="cpu"),
                               verbose=False, overlay_status=False)
    t, errors = _serve_in_thread(server, n_frames)
    cli = _client(client_kind, server.port, cfg)
    cli.connect()
    assert cli.wire_format == "v3"
    states = _oracle_states(cfg, 4, n_frames)
    got = _drain(cli)
    t.join(timeout=30)
    server.close()
    assert not t.is_alive() and not errors
    assert len(got) == n_frames
    for (_, recon), want in zip(got, states[1:]):
        np.testing.assert_array_equal(recon, want)


CAPACITY = 1500


def _overflow_script(cfg, n_tail):
    """[small, OVERFLOW (~40% density: bitmask-natural, so a raw frame on
    the wire proves the recovery fired), small...] — the JAX package's
    TestOverflowResync script."""
    base = np.zeros(cfg.frame_bytes, np.uint8)
    f1 = base.copy()
    f1[:500] = 100
    f2 = f1.copy()
    f2[2000:5700] += 200  # 3700 changed bytes > CAPACITY
    frames = [f1, f2]
    prev_tail = f2
    for k in range(n_tail):
        ft = prev_tail.copy()
        ft[100 + 400 * k: 400 + 400 * k] += 50
        frames.append(ft)
        prev_tail = ft
    return base, frames


@pytest.mark.parametrize("client_kind", ["port", "jax"])
@pytest.mark.parametrize("kind", ["sync", "pipelined"])
def test_v3_raw_resync_keeps_client_exact(cfg, kind, client_kind):
    """A capacity overflow under wire v3 ships one raw frame; the client
    stays on the oracle states, in order, and ends on the last one."""
    cfg = dataclasses.replace(cfg, wire_format="v3",
                              payload_capacity=CAPACITY)
    base, frames = _overflow_script(cfg, 2 if kind == "pipelined" else 1)
    cls = PipelinedExecutor if kind == "pipelined" else StreamExecutor
    server = DeltaStreamServer(cfg, ScriptedSource(base, frames),
                               executor=cls(cfg, device="cpu"),
                               verbose=False, overlay_status=False)
    t, errors = _serve_in_thread(server, len(frames))
    cli = _client(client_kind, server.port, cfg)
    cli.connect()
    np.testing.assert_array_equal(cli.frame, base)
    prev, expected = base.copy(), []
    for f in frames:
        prev = ref.step_oracle(prev, f, cfg)[0]
        expected.append(prev.copy())
    got = _drain(cli)
    t.join(timeout=30)
    server.close()
    assert not t.is_alive() and not errors
    positions = [p for p, _ in got]
    assert positions.count(cfg.frame_bytes) == 1, positions
    assert 0 < positions[-1] < cfg.frame_bytes, positions
    exp_i = 0
    for _, recon in got:
        while exp_i < len(expected) and not np.array_equal(
                recon, expected[exp_i]):
            exp_i += 1
        assert exp_i < len(expected), "client state matches no oracle state"
    np.testing.assert_array_equal(got[-1][1], expected[-1])


@pytest.mark.parametrize("wire_format", ["v1", "v2"])
def test_v1_v2_overflow_is_fatal(cfg, wire_format):
    cfg = dataclasses.replace(cfg, wire_format=wire_format,
                              payload_capacity=CAPACITY)
    base, frames = _overflow_script(cfg, 1)
    server = DeltaStreamServer(cfg, ScriptedSource(base, frames),
                               verbose=False, overlay_status=False,
                               device="cpu")
    t, errors = _serve_in_thread(server, len(frames))
    cli = _client("port", server.port, cfg)
    cli.connect()
    got = _drain(cli)
    t.join(timeout=30)
    server.close()
    assert len(got) == 1  # the first frame; the second overflows
    assert len(errors) == 1 and isinstance(errors[0], PayloadOverflowError)


def test_server_main_tiled_pipelined_v3(capsys):
    """The command-line entry points on the tiled, pipelined v3 path."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = ["--height", "48", "--width", "64", "--frames", "4",
            "--port", str(port), "--device", "cpu", "--tiled", "--pipelined",
            "--wire", "v3", "--fetch", "flat", "--subtile", "8"]
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
                                  "--width", "64", "--frames", "4"])
            break
        except ConnectionRefusedError:
            threading.Event().wait(0.05)
    t.join(timeout=30)
    assert rc == 0 and not errors and not t.is_alive()
    assert "decoded 4 frames" in capsys.readouterr().out


@pytest.mark.parametrize("flags,error", [
    (["--wire", "v4"], None),
    (["--tiled", "--fetch", "mask"], None),
    (["--tiled", "--bitmask"], None),
    (["--tiled", "--fetch", "mask", "--maskonly"], None),
    (["--tiled", "--land-batch", "2"], None),
    (["--fetch", "flat"], SystemExit),
    (["--tiled", "--capacity", "100"], SystemExit),
    (["--tiled", "--maskonly"], SystemExit),
    (["--bitmask"], SystemExit),
    (["--land-batch", "2"], SystemExit),
    (["--tiled", "--land-batch", "2", "--pipelined"], SystemExit),
], ids=["v4", "fetch_mask", "bitmask", "maskonly", "land_batch",
        "fetch_without_tiled", "capacity_with_tiled",
        "maskonly_without_fetch_mask", "bitmask_without_tiled",
        "land_batch_without_tiled", "land_batch_with_pipelined"])
def test_server_main_refuses(flags, error, monkeypatch):
    """The command line refuses flag combinations the JAX server refuses;
    the mask slice's flags (refused until ROADMAP M8) map to the config
    and executor as the JAX server maps them."""
    served = []
    monkeypatch.setattr(server_mod.DeltaStreamServer, "serve",
                        lambda self, max_frames=None: served.append(self)
                        or 0)
    if error is not None:
        with pytest.raises(error):
            server_mod.main(["--device", "cpu", "--frames", "1"] + flags)
        assert not served
        return
    assert server_mod.main(["--device", "cpu", "--frames", "1", "--height",
                            "48", "--width", "64"] + flags) == 0
    (srv,) = served
    c = srv.cfg
    mask_flavor = "--bitmask" in flags or "mask" in flags
    assert c.emit_bitmask == mask_flavor
    assert c.mask_payload == (mask_flavor and c.wire_format == "v4")
    assert c.maskonly_payload == ("--maskonly" in flags)
    want = BatchedLandExecutor if "--land-batch" in flags else StreamExecutor
    assert type(srv.executor) is want
    if want is BatchedLandExecutor:
        assert srv.executor.depth == 2


def test_client_refuses_v4(monkeypatch):
    """Wire v4 was refused until ROADMAP M8: a client pinned to v4 reads
    the v4 magic, one on auto sniffs it, and a v4 client refuses a v3
    stream."""
    base = np.arange(48, dtype=np.uint8)
    for pinned, sent, ok in (("v4", wire.MAGIC_V4, True),
                             ("auto", wire.MAGIC_V4, True),
                             ("v4", wire.MAGIC_V3, False)):
        a, b = socket.socketpair()
        with a, b:
            monkeypatch.setattr(client_mod.socket, "create_connection",
                                lambda addr, b=b: b)
            a.sendall(sent + base.tobytes())
            cli = DeltaStreamClient(height=4, width=4, wire_format=pinned)
            if ok:
                cli.connect()
                assert cli.wire_format == "v4"
                np.testing.assert_array_equal(cli.frame, base)
            else:
                with pytest.raises(ValueError, match="magic"):
                    cli.connect()


def test_client_pins_the_wire_magic(monkeypatch):
    """A client pinned to v2/v3 refuses a stream without that magic, and
    one pinned to v1 reads a v1 stream."""
    base = np.arange(48, dtype=np.uint8)
    for pinned, sent, ok in (("v3", wire.MAGIC_V2, False),
                             ("v2", wire.MAGIC_V2, True),
                             ("v1", b"", True)):
        a, b = socket.socketpair()
        with a, b:
            monkeypatch.setattr(client_mod.socket, "create_connection",
                                lambda addr, b=b: b)
            a.sendall(sent + base.tobytes())
            cli = DeltaStreamClient(height=4, width=4, wire_format=pinned)
            if ok:
                cli.connect()
                np.testing.assert_array_equal(cli.frame, base)
            else:
                with pytest.raises(ValueError, match="magic"):
                    cli.connect()


@pytest.mark.parametrize("unit_bytes", [128, 256, 1024, 63_488, 65_536,
                                        131_072])
def test_lander_narrowing_matches_jax(rng, unit_bytes):
    """The unit-local dtype and the host rebuild of global indices are the
    JAX lander's."""
    ours = TiledLander.compact_dtype(unit_bytes)
    assert ours == JaxLander._compact_dtype(unit_bytes)
    if ours is None:
        return
    rows, t_lo = 6, 3
    counts = rng.integers(0, min(unit_bytes, 200), rows, endpoint=True)
    local = np.zeros((rows, unit_bytes), ours)
    for r, c in enumerate(counts):
        local[r, :c] = np.sort(rng.choice(unit_bytes, c, replace=False))
    got = TiledLander.rebuild_xs(local, counts, t_lo, unit_bytes)
    want = JaxLander._rebuild_xs(local, counts, t_lo, t_lo, t_lo + rows,
                                 unit_bytes)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_lander_auto_follows_the_byte_model():
    """auto takes each offered flavor until it is measured (tiles first,
    mask only where bits exist), then the flavor that moves fewer bytes
    per the measured rate and extra times; empty frames land as tiles."""
    lander = TiledLander("auto")
    assert [lander.pick(10, 0, 1000, 128, True),
            lander.pick(0, 0, 0, 128, True)] == ["tiles", "tiles"]
    lander.copy_bytes_per_s = 1e10
    assert lander.pick(10, 0, 1000, 128, False) == "flat"
    lander.extra_s["flat"] = 1e-4
    assert lander.pick(10, 0, 1000, 128, True) == "mask"
    lander.extra_s["mask"] = 1e-4
    # a dense span: 2 B x 128 x 48,608 slots vs 5 B x 3.1M entries vs
    # 777 KB of bits + 3.1 MB of vals: the mask moves fewest bytes
    assert lander.pick(3_100_000, 0, 48_608, 128, True) == "mask"
    assert lander.pick(3_100_000, 0, 48_608, 128, False) == "tiles"
    # a sparse, wide span: 5 KB of entries + the merge
    assert lander.pick(1_000, 0, 48_608, 128, True) == "flat"
    assert lander.pick(0, 0, 0, 128, True) == "tiles"
    for mode in ("flat", "tiles", "mask"):
        assert TiledLander(mode).pick(10**6, 0, 48_608, 128, True) == mode
    # "shards" (multiserve --mesh) lands per-shard blocks through
    # land_many only; a name that is no flavor is refused
    with pytest.raises(ValueError, match="land_many"):
        TiledLander("shards").land(0, np.zeros(1, np.uint8), (None,) * 4,
                                   None, None)
    with pytest.raises(ValueError):
        TiledLander("windows")


def test_auto_landing_survives_a_static_start():
    """A stream that starts on a static scene: frames 1-2 equal the base,
    frames 3-8 each change 500 bytes. The auto landing used to measure
    the copy rate only on a non-empty tiles landing and then divide by
    it unmeasured (TypeError on frame 5); each frame now lands, and
    equals what the JAX executor lands."""
    from cudavideostream_tpu.config import StreamConfig as JaxConfig
    from cudavideostream_tpu.runtime.executor import (
        StreamExecutor as JaxExecutor,
    )

    cfg = StreamConfig(height=120, width=160, tiled_payload=True)
    rng = np.random.default_rng(5)
    base = rng.integers(0, 255, cfg.frame_bytes, endpoint=True,
                        dtype=np.uint8)
    frames, f = [base.copy(), base.copy()], base.copy()
    for _ in range(6):
        f = f.copy()
        idx = rng.choice(cfg.frame_bytes, 500, replace=False)
        f[idx] ^= 0x80  # a jump of 128: every flipped byte ships
        frames.append(f)
    ours = StreamExecutor(cfg, device="cpu")
    # the JAX executor lands tiles every frame: its own auto choice follows
    # host timings, and the reference payload must not depend on them
    theirs = JaxExecutor(JaxConfig(height=120, width=160,
                                   tiled_payload=True, fetch_mode="tiles"))
    ours.start(base)
    theirs.start(base)
    for k, frame in enumerate(frames):
        a, b = ours.process(frame), theirs.process(frame)
        assert a[0] == b[0] == (0 if k < 2 else a[0]) and (k < 2 or a[0])
        fa = a[1].to_flat() if a[2] is None else a[1:3]
        fb = b[1].to_flat()
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)
    assert theirs.fetch_counts["tiles"] == len(frames)
    # empty frames land as tiles and teach nothing; then each flavor twice
    assert ours.fetch_counts["tiles"] >= 4 and ours.fetch_counts["flat"] >= 2


def test_pipelined_executor_lags_one_frame(cfg):
    """process returns the previous frame's payload (None for the first),
    flush the last; resync drops the pending payload."""
    tcfg = dataclasses.replace(cfg, tiled_payload=True, fetch_mode="tiles")
    src = SyntheticSource(tcfg, seed=2)
    base = src.base_frame()
    frames = [next(src) for _ in range(3)]
    sync, pipe = (StreamExecutor(tcfg, device="cpu"),
                  PipelinedExecutor(tcfg, device="cpu"))
    sync.start(base)
    pipe.start(base)
    want = [sync.process(f) for f in frames]
    got = [pipe.process(f) for f in frames] + [pipe.flush()]
    assert got[0] is None and pipe.flush() is None
    for (pa, xa, _, _), (pb, xb, _, _) in zip(got[1:], want):
        assert pa == pb
        for a, b in zip(xa.to_flat(), xb.to_flat()):
            np.testing.assert_array_equal(a, b)
    pipe.process(frames[0])
    np.testing.assert_array_equal(pipe.resync(), pipe._state.numpy())
    assert pipe.flush() is None
