"""The port's multi-stream serving path on the CPU: the multi-stream server
(B streams, one batched step per frame), the broadcast server (one stream,
many clients) and the session replayer, over real loopback sockets. Each
is held against an oracle replay of its sources, the JAX package's client,
and the bytes the JAX package's own server sends on the same seeds.

Every socket test synchronises on events or on the bytes received, never
on a sleep, and every read has a timeout.
"""

import dataclasses
import gzip
import queue
import socket
import threading

import numpy as np
import pytest

from conftest import ScriptedSource
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.config import Visualizer as JaxVisualizer
from cudavideostream_tpu.runtime import broadcast as jax_broadcast
from cudavideostream_tpu.runtime import multiserve as jax_multiserve
from cudavideostream_tpu.runtime import sources as jax_sources
from cudavideostream_tpu.runtime.client import DeltaStreamClient as JaxClient
from cudavideostream_tpu.runtime.replay import ReplayServer as JaxReplay
from cudavideostream_tpu_torch.config import (
    PayloadOverflowError,
    StreamConfig,
    Visualizer,
)
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.runtime import broadcast
from cudavideostream_tpu_torch.runtime import client as client_mod
from cudavideostream_tpu_torch.runtime import multiserve
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.broadcast import (
    BroadcastServer,
    ClientSender,
)
from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
from cudavideostream_tpu_torch.runtime.executor import (
    ExecMetrics,
    TiledLander,
    _Copier,
    _Staged,
)
from cudavideostream_tpu_torch.runtime.multiserve import MultiStreamServer
from cudavideostream_tpu_torch.runtime.replay import ReplayServer
from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer
from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

TIMEOUT = 30


@pytest.fixture
def cfg():
    return StreamConfig(height=48, width=64, overlay_scale=4, port=0)


def jax_config(cfg) -> JaxConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JaxConfig)
          if f.name not in ("visualizer", "compaction")}
    return JaxConfig(visualizer=JaxVisualizer(cfg.visualizer.value), **kw)


class _SignalQueue(queue.Queue):
    """A server's queue of pending clients that counts its arrivals: a
    test starts serving once its clients are queued, so each is admitted
    at the first frame."""

    def __init__(self):
        super().__init__()
        self.arrived = threading.Semaphore(0)

    def put(self, item, block=True, timeout=None):
        super().put(item, block, timeout)
        self.arrived.release()

    def wait(self, k=1):
        assert all(self.arrived.acquire(timeout=TIMEOUT) for _ in range(k))


def _thread(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


def _raw_reader(port, out: bytearray):
    """Connect now; record every byte until the server closes."""
    sock = socket.create_connection(("127.0.0.1", port))
    sock.settimeout(TIMEOUT)

    def run():
        with sock:
            while chunk := sock.recv(1 << 16):
                out.extend(chunk)

    return _thread(run)


def _decoder(kind, port, cfg, got):
    """A client (the port's or the JAX package's) that connects and keeps
    the base frame and every decoded state until the server closes."""
    cls = DeltaStreamClient if kind == "port" else JaxClient
    cli = cls("127.0.0.1", port, cfg.height, cfg.width)

    def run():
        try:
            cli.connect()
            cli.sock.settimeout(TIMEOUT)
            got.append(cli.frame.copy())
            while True:
                got.append(cli.read_frame()[1].copy())
        except (ConnectionError, OSError):
            pass
        finally:
            cli.close()

    return _thread(run)


def _serve(server, n_frames, **kw):
    errors = []

    def run():
        try:
            server.serve(max_frames=n_frames, **kw)
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    return _thread(run), errors


def _join(t, readers, errors=()):
    t.join(TIMEOUT)
    for r in readers:
        r.join(TIMEOUT)
    assert not t.is_alive() and not any(r.is_alive() for r in readers)
    assert not errors, errors


def _states(cfg, source, n_frames, prev=None):
    """Oracle states of a source: its base frame (unless ``prev`` is
    given) and the state after each frame."""
    prev = source.base_frame().copy() if prev is None else prev
    states = [prev]
    for _ in range(n_frames):
        prev = ref.step_oracle(prev, next(source), cfg)[0]
        states.append(prev)
    return states


class _Gated(SyntheticSource):
    """A synthetic source that, asked for frame ``gate_at`` (after its
    base frame), sets ``at_gate`` and waits for ``gate``."""

    def __init__(self, cfg, seed, gate_at):
        super().__init__(cfg, seed=seed)
        self.gate_at, self.served = gate_at, 0
        self.at_gate, self.gate = threading.Event(), threading.Event()

    def __next__(self):
        if self.served == 1 + self.gate_at:
            self.at_gate.set()
            assert self.gate.wait(TIMEOUT)
        self.served += 1
        return super().__next__()


def _multi(cfg, n_streams, cls=MultiStreamServer, seed=0, **kw):
    """A multi-stream server (the port's or the JAX package's) on the
    synthetic sources ``seed + b``, its pending queues counting."""
    if cls is MultiStreamServer:
        server = cls(cfg, [SyntheticSource(cfg, seed=seed + b)
                           for b in range(n_streams)],
                     verbose=False, overlay_status=False, device="cpu", **kw)
    else:
        jcfg = jax_config(cfg)
        server = cls(jcfg, [jax_sources.SyntheticSource(jcfg, seed=seed + b)
                            for b in range(n_streams)],
                     verbose=False, overlay_status=False, **kw)
    server._pending = [_SignalQueue() for _ in range(n_streams)]
    server.listen()
    return server


# -- the multi-stream server -------------------------------------------------

MULTI = [("v1", True, "auto"), ("v2", True, "tiles"), ("v3", True, "flat"),
         ("v4", True, "auto"), ("v1", False, "auto"), ("v3", False, "auto")]


@pytest.mark.parametrize("client_kind", ["port", "jax"])
@pytest.mark.parametrize("wire_format,tiled,fetch", MULTI,
                         ids=[f"{w}-{'tiled' if t else 'flat'}-{f}"
                              for w, t, f in MULTI])
def test_multiserve_loopback_byte_exact(cfg, wire_format, tiled, fetch,
                                        client_kind):
    """Two streams, a client on each from the first frame (the port's or
    the JAX package's, wire auto): every decoded state equals the oracle
    replay of that stream's source, on the batched fast path (tiled, each
    landing flavor) and on the flat path."""
    cfg = dataclasses.replace(cfg, wire_format=wire_format,
                              tiled_payload=tiled, fetch_mode=fetch)
    n_frames = 5
    server = _multi(cfg, 2, seed=3)
    got = [[], []]
    readers = [_decoder(client_kind, p, cfg, got[b])
               for b, p in enumerate(server.ports)]
    for q in server._pending:
        q.wait()
    t, errors = _serve(server, n_frames)
    _join(t, readers, errors)
    for b in range(2):
        want = _states(cfg, SyntheticSource(cfg, seed=3 + b), n_frames)
        assert len(got[b]) == n_frames + 1
        for g, w in zip(got[b], want):
            np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0][-1], got[1][-1])
    if tiled:
        counts = server.fetch_counts
        assert sum(counts.values()) == 2 * n_frames
        if fetch != "auto":
            assert counts[fetch] == 2 * n_frames
    assert server.metrics.total_frames == n_frames


@pytest.mark.parametrize("wire_format,tiled", [
    ("v1", True), ("v3", True), ("v4", True), ("v1", False), ("v3", False)])
def test_multiserve_wire_bytes_match_jax(cfg, wire_format, tiled):
    """Raw readers on every stream of the port's server and of the JAX
    package's, on the same seeds: the same bytes, stream for stream."""
    cfg = dataclasses.replace(cfg, wire_format=wire_format,
                              tiled_payload=tiled)
    n_frames = 4
    streams = {}
    for cls in (MultiStreamServer, jax_multiserve.MultiStreamServer):
        server = _multi(cfg, 2, cls=cls, seed=11)
        raw = [bytearray(), bytearray()]
        readers = [_raw_reader(p, raw[b]) for b, p in enumerate(server.ports)]
        for q in server._pending:
            q.wait()
        t, errors = _serve(server, n_frames)
        _join(t, readers, errors)
        streams[cls] = raw
    port, jax = streams.values()
    assert len(port[0]) > cfg.frame_bytes
    assert port == jax


def test_multiserve_late_joiner_and_latest_client_wins(cfg):
    """A client joining stream 1 mid-stream gets the stream's current
    reconstruction as its base frame and the oracle states after it; a
    second client on stream 0 replaces the first (the latest wins), which
    is then closed."""
    n_frames, gate_at = 7, 3
    server = _multi(cfg, 2, seed=5)
    server.sources[0] = _Gated(cfg, 5, gate_at)
    first, late0, late1 = [], [], []
    readers = [_decoder("port", server.ports[0], cfg, first)]
    server._pending[0].wait()
    t, errors = _serve(server, n_frames)
    assert server.sources[0].at_gate.wait(TIMEOUT)
    readers += [_decoder("port", server.ports[0], cfg, late0),
                _decoder("port", server.ports[1], cfg, late1)]
    server._pending[0].wait()
    server._pending[1].wait()
    server.sources[0].gate.set()
    _join(t, readers, errors)
    # the late clients were queued during frame gate_at and admitted after it
    for b, got in ((0, late0), (1, late1)):
        want = _states(cfg, SyntheticSource(cfg, seed=5 + b), n_frames)
        assert len(got) == n_frames - gate_at
        for g, w in zip(got, want[gate_at + 1:]):
            np.testing.assert_array_equal(g, w)
    want0 = _states(cfg, SyntheticSource(cfg, seed=5), n_frames)
    assert len(first) == gate_at + 2
    for g, w in zip(first, want0):
        np.testing.assert_array_equal(g, w)


def test_multiserve_checkpoint_then_resume(cfg, tmp_path):
    """--checkpoint-to writes each stream's reconstruction (the JAX
    server's ``.npz``); a server resumed from it ships that state as the
    base frame, and its deltas track the oracle from there (the restarted
    sources serve from their first frame: a resume never reads a base
    frame). A checkpoint of another geometry is refused."""
    cfg = dataclasses.replace(cfg, tiled_payload=True)
    ckpt = str(tmp_path / "ms_state")
    server = _multi(cfg, 2, seed=4)
    readers = [_raw_reader(p, bytearray()) for p in server.ports]
    for q in server._pending:
        q.wait()
    t, errors = _serve(server, 3, checkpoint_to=ckpt)
    _join(t, readers, errors)
    data = np.load(ckpt + ".npz")
    assert tuple(data["geometry"]) == (2, cfg.height, cfg.width)
    wants = [_states(cfg, SyntheticSource(cfg, seed=4 + b), 3)
             for b in range(2)]
    for b in range(2):
        np.testing.assert_array_equal(data["recon"][b], wants[b][-1])

    server2 = _multi(cfg, 2, seed=4)
    got = [[], []]
    readers = [_decoder("jax", p, cfg, got[b])
               for b, p in enumerate(server2.ports)]
    for q in server2._pending:
        q.wait()
    t, errors = _serve(server2, 2, resume_from=ckpt)
    _join(t, readers, errors)
    for b in range(2):
        src = SyntheticSource(cfg, seed=4 + b)
        want = [wants[b][-1]]
        for _ in range(2):
            want.append(ref.step_oracle(want[-1], next(src), cfg)[0])
        for g, w in zip(got[b], want):
            np.testing.assert_array_equal(g, w)
        assert len(got[b]) == 3

    bad = str(tmp_path / "bad.npz")
    np.savez(bad, recon=np.zeros((3, cfg.frame_bytes), np.uint8),
             geometry=np.array([3, cfg.height, cfg.width]))
    server3 = _multi(cfg, 2)
    with pytest.raises(ValueError, match="geometry"):
        server3.serve(max_frames=1, resume_from=bad, wait_first_client=False)


def test_multiserve_refuses_the_mask_landing(cfg):
    cfg = dataclasses.replace(cfg, tiled_payload=True, fetch_mode="mask",
                              emit_bitmask=True)
    with pytest.raises(ValueError, match="fetch_mode 'mask'"):
        MultiStreamServer(cfg, [SyntheticSource(cfg)], device="cpu")


@pytest.mark.parametrize("wire_format", ["v3", "v4", "v1"])
def test_multiserve_overflow_resyncs_one_stream(cfg, wire_format):
    """The flat path with --capacity: under v3/v4 a stream whose frame
    overflows gets one raw frame and the other stream's deltas are
    untouched, both exact; under v1 the overflow is fatal."""
    cap = 1500
    cfg = dataclasses.replace(cfg, wire_format=wire_format,
                              payload_capacity=cap)
    base = np.zeros(cfg.frame_bytes, np.uint8)
    s0, prev = [], base
    for k in range(3):
        prev = prev.copy()
        prev[50 * k:50 * k + 200] += 60
        s0.append(prev)
    f1 = base.copy()
    f1[:500] = 100
    f2 = f1.copy()
    f2[2000:5700] += 200  # 3700 changed bytes > cap
    f3 = f2.copy()
    f3[100:400] += 50
    server = MultiStreamServer(
        cfg, [ScriptedSource(base, s0), ScriptedSource(base, [f1, f2, f3])],
        verbose=False, overlay_status=False, device="cpu")
    server._pending = [_SignalQueue(), _SignalQueue()]
    server.listen()
    raw = [bytearray(), bytearray()]
    readers = [_raw_reader(p, raw[b]) for b, p in enumerate(server.ports)]
    for q in server._pending:
        q.wait()
    t, errors = _serve(server, 3)
    t.join(TIMEOUT)
    for r in readers:
        r.join(TIMEOUT)
    if wire_format == "v1":
        assert len(errors) == 1 and isinstance(errors[0],
                                               PayloadOverflowError)
        return
    assert not errors
    for b, frames in enumerate((s0, [f1, f2, f3])):
        data = bytes(raw[b])
        off = len(wire.MAGIC_V3) + cfg.frame_bytes
        state, modes = base.copy(), []
        while off < len(data):
            end = wire.v3_frame_extent(data, off, cfg.frame_bytes)
            modes.append(data[off])
            pos, xs, vals, rawf = wire.unpack_frame_v3(data, off,
                                                       cfg.frame_bytes)[:4]
            if rawf is not None:
                state = rawf
            else:
                state = ref.client_apply(state, xs, vals)
            off = end
        want = base
        for f in frames:
            want = ref.step_oracle(want, f, cfg)[0]
        np.testing.assert_array_equal(state, want)
        assert modes.count(wire.MODE_RAW) == (1 if b == 1 else 0), modes


def test_multiserve_aux_dir_matches_jax(cfg, tmp_path):
    """--visualizer 5 --aux-dir: the per-stream PPM files (aux_<b>_<n>)
    are the JAX server's, byte for byte."""
    cfg = dataclasses.replace(cfg, tiled_payload=True,
                              visualizer=Visualizer.BINARIZE)
    files = {}
    for cls in (MultiStreamServer, jax_multiserve.MultiStreamServer):
        out = tmp_path / cls.__module__.split(".")[0]
        out.mkdir()
        server = _multi(cfg, 2, cls=cls, seed=6, aux_dir=str(out),
                        aux_every=1)
        readers = [_raw_reader(p, bytearray()) for p in server.ports]
        for q in server._pending:
            q.wait()
        t, errors = _serve(server, 3)
        _join(t, readers, errors)
        files[cls] = {p.name: p.read_bytes() for p in out.iterdir()}
    port, jax = files.values()
    assert sorted(port) == [f"aux_{b}_{k:06d}.ppm" for b in range(2)
                            for k in range(3)]
    assert port == jax


def _free_ports(k):
    """A port p with p .. p + k - 1 free (as far as binding shows)."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        try:
            socks = [socket.socket() for _ in range(k)]
            for i, s in enumerate(socks):
                s.bind(("127.0.0.1", p + i))
            return p
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range")


def test_multiserve_main_and_client_main(capsys, tmp_path):
    """The command lines end to end on the CPU: two streams, a client
    main on each, and the checkpoint."""
    port = _free_ports(2)
    ckpt = str(tmp_path / "ck.npz")
    args = ["--streams", "2", "--height", "48", "--width", "64", "--frames",
            "8", "--port", str(port), "--device", "cpu", "--wire", "v3",
            "--checkpoint-to", ckpt]
    errors = []

    def serve():
        try:
            multiserve.main(args)
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    t = _thread(serve)
    rcs = []

    def client(b):
        for _ in range(400):  # until the server listens
            try:
                rcs.append(client_mod.main(["--port", str(port + b),
                                            "--height", "48", "--width",
                                            "64", "--frames", "2"]))
                return
            except ConnectionRefusedError:
                threading.Event().wait(0.05)

    readers = [_thread(lambda b=b: client(b)) for b in range(2)]
    _join(t, readers, errors)
    assert rcs == [0, 0]
    assert capsys.readouterr().out.count("decoded 2 frames") == 2
    assert tuple(np.load(ckpt)["geometry"]) == (2, 48, 64)


@pytest.mark.parametrize("module,argv,want", [
    (multiserve, ["--mesh", "1,1"], ("mesh", (1, 1))),
    (multiserve, ["--source", "file"],
     (ValueError, "file source needs --path")),
    (multiserve, ["--path", "x.npy"], ("path", "x.npy")),
    (broadcast, ["--link-cache", "l.json"], ("link_cache", "l.json")),
    (broadcast, ["--calibrate", "2"], ("calibrate", 2)),
    (broadcast, ["--source", "v4l2", "--path", "/nonexistent/video9"],
     (RuntimeError, "camera device /nonexistent/video9 not present")),
], ids=["multi_mesh", "multi_file", "multi_path", "bc_link_cache",
        "bc_calibrate", "bc_v4l2"])
def test_entry_points_name_their_roadmap_item(module, argv, want):
    """Options of parts not ported yet name their ROADMAP.md item. Options
    ported since are taken (``want`` an attribute and its parsed value:
    ``--mesh``, M15; ``--path``, M16; ``--link-cache`` and ``--calibrate``,
    M13), or fail as the JAX entry points do (a file source without
    ``--path``, a camera that is not there)."""
    argv = argv + ["--device", "cpu", "--height", "48", "--width", "64"]
    key, value = want
    if isinstance(key, str):
        assert getattr(module.parse_args(argv), key) == value
        return
    with pytest.raises(key, match=value):
        module.main(argv)


# -- landing several streams at once ----------------------------------------

@pytest.mark.parametrize("mode", ["tiles", "flat", "auto"])
def test_land_many_equals_land(cfg, mode):
    """``land_many`` lands each stream as ``land`` does on its own, empty
    streams included, in the flavor each is given (``auto`` teaches
    itself from the shared batch)."""
    from cudavideostream_tpu_torch.models import BatchedDeltaPipeline

    cfg = dataclasses.replace(cfg, tiled_payload=True, fetch_mode=mode)
    pipe = BatchedDeltaPipeline(cfg, 3, device="cpu")
    rng = np.random.default_rng(9)
    n = cfg.frame_bytes
    bases = rng.integers(0, 256, (3, n), dtype=np.uint8)
    lander, copier = TiledLander(mode), _Copier(pipe.device)
    prev = pipe.init_state(bases)
    for k in range(5):
        frames = bases.copy()
        frames[0] = rng.integers(0, 256, n, dtype=np.uint8)
        frames[2, : 50 * (k + 1)] += 100
        outs = pipe.step(prev, frames)[1:]
        staged = _Staged(outs, 2)
        pos, counts = staged.wait()
        got = lander.land_many(
            [(int(pos[b]), counts[b].astype(np.int32), outs[1][b], outs[2][b],
              outs[3][b]) for b in range(3)], staged, copier)
        assert got[1].pos == 0 if isinstance(got[1], wire.TiledPayload) \
            else got[1][0].size == 0
        for b in range(3):
            xs, vals = (got[b].to_flat() if isinstance(got[b],
                                                       wire.TiledPayload)
                        else got[b])
            want = wire.TiledPayload(int(pos[b]), counts[b],
                                     outs[2][b].numpy(),
                                     outs[3][b].numpy()).to_flat()
            np.testing.assert_array_equal(xs, want[0])
            np.testing.assert_array_equal(vals, want[1])
    assert sum(lander.fetch_counts.values()) == 15
    if mode != "auto":
        assert lander.fetch_counts[mode] == 15
    else:
        assert lander.fetch_counts["flat"] >= 2
    with pytest.raises(ValueError, match="mask"):
        TiledLander("mask").land_many([], staged, copier)


def test_exec_metrics_count_the_bytes_sent():
    m = ExecMetrics()
    m.record(0.01, 10)
    m.record(0.01, 10, wire_bytes=7)
    assert m.wire_bytes == 4 + 5 * 10 + 7


# -- the broadcast server ----------------------------------------------------

def _broadcast(cfg, source, cls=BroadcastServer, **kw):
    if cls is BroadcastServer:
        server = cls(cfg, source, verbose=False, overlay_status=False,
                     device="cpu", **kw)
    else:
        server = cls(jax_config(cfg), source, verbose=False,
                     overlay_status=False, **kw)
    server._pending = _SignalQueue()
    server.listen()
    return server


BCAST = [("v1", False, "auto"), ("v3", False, "auto"), ("v2", True, "flat"),
         ("v4", True, "mask")]


@pytest.mark.parametrize("wire_format,tiled,fetch", BCAST,
                         ids=[f"{w}-{'tiled' if t else 'flat'}-{f}"
                              for w, t, f in BCAST])
def test_broadcast_fanout_bytes(cfg, wire_format, tiled, fetch):
    """Two raw readers and a decoding client from the first frame: both
    readers get the same bytes, which are the JAX broadcast server's on
    the same seed, and the client decodes every oracle state."""
    mask = fetch == "mask"
    cfg = dataclasses.replace(cfg, wire_format=wire_format,
                              tiled_payload=tiled, fetch_mode=fetch,
                              emit_bitmask=mask,
                              mask_payload=mask and wire_format == "v4")
    n_frames = 4
    raws = {}
    for cls in (BroadcastServer, jax_broadcast.BroadcastServer):
        src = (SyntheticSource(cfg, seed=8) if cls is BroadcastServer
               else jax_sources.SyntheticSource(jax_config(cfg), seed=8))
        server = _broadcast(cfg, src, cls)
        raw = [bytearray(), bytearray()]
        readers = [_raw_reader(server.port, r) for r in raw]
        got = []
        if cls is BroadcastServer:
            readers.append(_decoder("port", server.port, cfg, got))
        server._pending.wait(len(readers))
        t, errors = _serve(server, n_frames)
        _join(t, readers, errors)
        assert raw[0] == raw[1]
        raws[cls] = raw[0]
        if cls is BroadcastServer:
            want = _states(cfg, SyntheticSource(cfg, seed=8), n_frames)
            assert len(got) == n_frames + 1
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            assert server.n_clients == 0 and not server.drops
    assert raws[BroadcastServer] == raws[jax_broadcast.BroadcastServer]


@pytest.mark.parametrize("wire_format", ["v1", "v3"])
def test_broadcast_late_joiner(cfg, wire_format):
    """A client joining mid-stream gets the current reconstruction as its
    base frame and then every oracle state; the first client is not
    disturbed."""
    cfg = dataclasses.replace(cfg, wire_format=wire_format)
    n_frames, gate_at = 6, 2
    source = _Gated(cfg, 2, gate_at)
    server = _broadcast(cfg, source)
    first, late = [], []
    readers = [_decoder("port", server.port, cfg, first)]
    server._pending.wait()
    t, errors = _serve(server, n_frames)
    assert source.at_gate.wait(TIMEOUT)
    readers.append(_decoder("jax", server.port, cfg, late))
    server._pending.wait()
    source.gate.set()
    _join(t, readers, errors)
    want = _states(cfg, SyntheticSource(cfg, seed=2), n_frames)
    assert len(first) == n_frames + 1 and len(late) == n_frames - gate_at
    for g, w in zip(first, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(late, want[gate_at + 1:]):
        np.testing.assert_array_equal(g, w)


class _Received(list):
    """The states a decoder keeps, with a wait for their count."""

    def __init__(self):
        super().__init__()
        self.grew = threading.Condition()

    def append(self, item):
        with self.grew:
            super().append(item)
            self.grew.notify_all()

    def wait_len(self, k):
        with self.grew:
            assert self.grew.wait_for(lambda: len(self) >= k, TIMEOUT)


class _Paced(ScriptedSource):
    """A scripted source that yields frame ``k`` once ``got`` holds ``k``
    states (the base frame and frames ``0..k-2``): the healthy client is
    never more than two frames behind, whatever the load on the host."""

    def __init__(self, base, frames, got):
        super().__init__(base, frames)
        self.got = got

    def __next__(self):
        self.got.wait_len(self._i)
        return super().__next__()


def test_broadcast_drops_a_backlogged_client(cfg, monkeypatch):
    """A connected client that never reads, behind small socket buffers,
    is dropped once its queue is MAX_QUEUE frames deep; the healthy client
    gets every frame, exact, and the stream runs to its end."""
    monkeypatch.setattr(ClientSender, "MAX_QUEUE", 4)
    base = np.zeros(cfg.frame_bytes, np.uint8)
    # every frame flips every byte past the threshold: ~46 KB a frame
    frames = [np.full(cfg.frame_bytes, 120 * (k % 2) + 60, np.uint8)
              for k in range(24)]
    got = _Received()
    server = _broadcast(cfg, _Paced(base, frames, got), sndbuf=4096)
    readers = [_decoder("port", server.port, cfg, got)]
    stalled = socket.socket()
    stalled.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    stalled.connect(("127.0.0.1", server.port))
    server._pending.wait(2)
    t, errors = _serve(server, len(frames))
    _join(t, readers, errors)
    stalled.close()
    assert any("backlog exceeded 4 frames" in r for r in server.drops)
    want = base
    assert len(got) == len(frames) + 1
    for g, f in zip(got[1:], frames):
        want = ref.step_oracle(want, f, cfg)[0]
        np.testing.assert_array_equal(g, want)


def test_client_sender_backlog():
    """The writer is stuck in sendall to a peer that never reads: offers
    fill the bounded queue and the next one marks the client dead."""
    a, b = socket.socketpair()
    with a, b:
        sender = ClientSender(a)
        buf = bytes(1 << 20)
        offers = [sender.offer(buf) for _ in range(ClientSender.MAX_QUEUE + 2)]
        assert offers[-1] is False and sender.dead
        assert sender.drop_reason == "backlog exceeded 32 frames"
        sender.close()
        sender.join(TIMEOUT)


# -- record and replay -------------------------------------------------------

def _record(cfg, n_frames, seed=9):
    """A session of the port's server, recorded by a raw socket reader."""
    server = DeltaStreamServer(cfg, SyntheticSource(cfg, seed=seed),
                               verbose=False, overlay_status=False,
                               device="cpu")
    server.listen()
    raw = bytearray()
    reader = _raw_reader(server.port, raw)
    t, errors = _serve(server, n_frames)
    _join(t, [reader], errors)
    server.close()
    return bytes(raw)


REPLAY = {"v1": {}, "v2": dict(wire_format="v2"), "v3": dict(wire_format="v3"),
          "v4_mask": dict(wire_format="v4", tiled_payload=True,
                          fetch_mode="mask", emit_bitmask=True,
                          mask_payload=True)}


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
@pytest.mark.parametrize("name", list(REPLAY))
def test_replay_is_byte_identical(cfg, tmp_path, name, gz):
    """A recorded session replays byte for byte to a raw reader, and a
    client decodes it to the oracle states; ``.gz`` files too."""
    cfg = dataclasses.replace(cfg, **REPLAY[name])
    n_frames = 4
    data = _record(cfg, n_frames)
    path = tmp_path / ("s.cvs.gz" if gz else "s.cvs")
    path.write_bytes(gzip.compress(data) if gz else data)
    rep = ReplayServer(str(path), cfg.frame_bytes, port=0, verbose=False)
    assert len(rep.marks) == n_frames
    rep.listen()
    t = _thread(lambda: rep.serve(max_clients=2))
    raw, got = bytearray(), []
    _raw_reader(rep.port, raw).join(TIMEOUT)
    _decoder("port", rep.port, cfg, got).join(TIMEOUT)
    t.join(TIMEOUT)
    rep.close()
    assert bytes(raw) == data
    want = _states(cfg, SyntheticSource(cfg, seed=9), n_frames)
    assert len(got) == n_frames + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("wire_format", ["v1", "v3"])
def test_replay_ignores_a_truncated_tail(cfg, tmp_path, wire_format):
    cfg = dataclasses.replace(cfg, wire_format=wire_format)
    data = _record(cfg, 3)
    path = tmp_path / "t.cvs"
    path.write_bytes(data[:-3])
    rep = ReplayServer(str(path), cfg.frame_bytes, port=0, verbose=False)
    assert len(rep.marks) == 2
    rep.listen()
    t = _thread(lambda: rep.serve(max_clients=1))
    raw = bytearray()
    _raw_reader(rep.port, raw).join(TIMEOUT)
    t.join(TIMEOUT)
    rep.close()
    assert bytes(raw) == data[:rep.marks[-1][1]]
    short = tmp_path / "short.cvs"
    short.write_bytes(data[:100])
    with pytest.raises(ValueError, match="shorter than one base frame"):
        ReplayServer(str(short), cfg.frame_bytes)


@pytest.mark.parametrize("name", list(REPLAY))
def test_replay_stats_match_jax(cfg, tmp_path, name, capsys):
    """``stats`` and ``format_stats`` of a recorded session are the JAX
    replayer's; the command line's ``--stats`` prints them."""
    cfg = dataclasses.replace(cfg, **REPLAY[name])
    path = tmp_path / "s.cvs"
    path.write_bytes(_record(cfg, 5))
    rep = ReplayServer(str(path), cfg.frame_bytes, verbose=False)
    jrep = JaxReplay(str(path), cfg.frame_bytes, verbose=False)
    assert rep.stats() == jrep.stats()
    assert rep.format_stats() == jrep.format_stats()
    rep.close()
    jrep.close()
    from cudavideostream_tpu_torch.runtime import replay

    assert replay.main([str(path), "--stats", "--height", "48", "--width",
                        "64"]) == 0
    assert "frames: 5" in capsys.readouterr().out


def test_v3_frame_extent_matches_jax(cfg):
    from cudavideostream_tpu.runtime import wire as jax_wire

    data = _record(dataclasses.replace(cfg, wire_format="v4",
                                       tiled_payload=True, fetch_mode="mask",
                                       emit_bitmask=True, mask_payload=True),
                   4)
    off, last = len(wire.MAGIC_V4) + cfg.frame_bytes, None
    while off < len(data):
        end = wire.v3_frame_extent(data, off, cfg.frame_bytes)
        assert end == jax_wire.v3_frame_extent(data, off, cfg.frame_bytes)
        last, off = off, end
    assert off == len(data)
    for cut in (len(data) - 1, last + 3):  # a torn body, a torn header
        with pytest.raises(ValueError, match="truncated"):
            wire.v3_frame_extent(data[:cut], last, cfg.frame_bytes)
    with pytest.raises(ValueError, match="unknown v3 mode"):
        wire.v3_frame_extent(b"\x09" + bytes(20), 0, cfg.frame_bytes)


@pytest.mark.parametrize("wire_format", ["v3", "v4"])
def test_stateless_encodes_match_jax(rng, wire_format):
    """``encode_frame_v3``/``encode_frame_v4`` (what the multi-stream
    server sends) are the JAX functions' bytes at every density."""
    from cudavideostream_tpu.runtime import wire as jax_wire

    n = 9216
    port_fn = getattr(wire, f"encode_frame_{wire_format}")
    jax_fn = getattr(jax_wire, f"encode_frame_{wire_format}")
    for k in (0, 5, 300, 2000, 6000, n):
        xs = np.sort(rng.choice(n, k, replace=False)).astype(np.int32)
        vals = rng.integers(1, 256, k, dtype=np.uint8)
        frame = rng.integers(0, 256, n, dtype=np.uint8)
        assert port_fn(k, xs, vals, frame) == jax_fn(k, xs, vals, frame)
