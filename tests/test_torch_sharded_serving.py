"""The port's sharded serving path on the CPU: ``ShardedDeltaPipeline.step``
(B streams over ``(data, space)`` meshes), the landing of padded shards,
the sharded executors, ``server --mesh`` and ``multiserve --mesh`` over
real loopback sockets, and every refusal the JAX package makes on that
path. Each is held against the JAX package (on ``tests/conftest.py``'s
virtual CPU devices), the JAX client and ``step_oracle``, byte for byte.

Every socket test synchronises on events or on the bytes received, never
on a sleep, and every read has a timeout.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from conftest import make_frame_pair
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.config import Visualizer as JaxVisualizer
from cudavideostream_tpu.parallel import ShardedDeltaPipeline as JaxSharded
from cudavideostream_tpu.parallel import make_mesh as jax_make_mesh
from cudavideostream_tpu.runtime import multiserve as jax_multiserve
from cudavideostream_tpu.runtime import server as jax_server
from cudavideostream_tpu.runtime import sharded_executor as jax_sharded_exec
from cudavideostream_tpu.runtime import sources as jax_sources
from cudavideostream_tpu.runtime import wire as jax_wire
from cudavideostream_tpu_torch.config import StreamConfig, Visualizer
from cudavideostream_tpu_torch.models import from_jax_sharded
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.parallel import ShardedDeltaPipeline, make_mesh
from cudavideostream_tpu_torch.parallel.sharded import gather
from cudavideostream_tpu_torch.runtime import multiserve
from cudavideostream_tpu_torch.runtime import server as server_mod
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.executor import TiledLander
from cudavideostream_tpu_torch.runtime.multiserve import MultiStreamServer
from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer
from cudavideostream_tpu_torch.runtime.sharded_executor import (
    PipelinedShardedExecutor,
    ShardedStreamExecutor,
)
from cudavideostream_tpu_torch.runtime.sources import SyntheticSource
from cudavideostream_tpu_torch.utils import fonts
from test_torch_multiserve import (
    _SignalQueue,
    _decoder,
    _join,
    _raw_reader,
    _serve,
)
from test_torch_runtime import (
    _client,
    _drain,
    _oracle_states,
    _serve_in_thread,
)

H, W = 48, 64


def jax_config(cfg) -> JaxConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JaxConfig)
          if f.name not in ("visualizer", "compaction")}
    return JaxConfig(visualizer=JaxVisualizer(cfg.visualizer.value), **kw)


def _assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


def _cfg(**kw):
    return StreamConfig(height=H, width=W, overlay_scale=1, port=0, **kw)


# -- step: B streams over the data axis ---------------------------------------

STEPS = [(b, mesh, layout) for b in (2, 4) for mesh in ((2, 2), (1, 4))
         for layout in ("sharded", "replicated")]


@pytest.mark.parametrize("b,mesh,layout", STEPS,
                         ids=[f"B{b}-{d}x{s}-{lay}"
                              for b, (d, s), lay in STEPS])
def test_step_matches_jax_and_oracle(b, mesh, layout):
    """``step`` with B streams, each with its own overlay text: the state,
    the payload and the aux frames equal the JAX sharded pipeline's, the
    ``"sharded"`` layout's ``payload_tiles`` equal the JAX package's, and
    every stream equals its step_oracle."""
    d, s = mesh
    viz = Visualizer.BINARIZE if b == 4 else Visualizer.RED_OVERLAP
    cfg = _cfg(visualizer=viz, noise_filter=b == 4)
    jpipe = JaxSharded(jax_config(cfg), jax_make_mesh(d * s, data_parallel=d),
                       payload_layout=layout)
    rng = np.random.default_rng([b, d, s])
    base = rng.integers(0, 256, (b, cfg.frame_bytes), dtype=np.uint8)
    jst = jpipe.init_state(base)
    pipe, st = from_jax_sharded(cfg, make_mesh(d * s, data_parallel=d,
                                               device="cpu"),
                                np.asarray(jst), conv_weights_q16=jpipe.conv_q16,
                                payload_layout=layout)
    prevs = list(base)
    for k in range(2):
        frames = np.stack([make_frame_pair(rng, cfg.frame_bytes)[1]
                           for _ in range(b)])
        texts = [f"S{i} F{k}" * (i + 1) for i in range(b)]
        out = jpipe.step(jst, frames, text=texts)
        jst = out[0]
        want = [np.asarray(o) for o in out]
        st, *got = pipe.step(st, frames, text=texts)
        _assert_same(gather(st), want[0])
        for g, w in zip(got[:3], want[1:4]):
            _assert_same(gather(g), w)
        _assert_same(gather(got[3]), want[4])
        for i in range(b):
            exp = ref.step_oracle(prevs[i], frames[i], cfg,
                                  atlas=pipe.atlas_np,
                                  char_ids=fonts.encode_text(texts[i]))
            _assert_same(gather(st)[i], exp[0])
            _assert_same(gather(got[3])[i], exp[4])
            if layout == "sharded":
                tp = pipe.payload_tiles(*got[:3], i)
                jtp = jpipe.payload_tiles(*want[1:4], i)
                for a in ("counts", "xs", "vals"):
                    _assert_same(getattr(tp, a), getattr(jtp, a))
                xs, vals = tp.to_flat()
            else:
                pos = int(gather(got[0])[i])
                xs, vals = (gather(got[1])[i, :pos],
                            gather(got[2])[i, :pos])
            _assert_same(xs, exp[2])
            _assert_same(vals, exp[3])
            prevs[i] = exp[0]


def test_step_refusals():
    """The stream count must divide by the data axis, and a text list must
    name every stream, as in the JAX package."""
    cfg = _cfg()
    pipe = ShardedDeltaPipeline(cfg, make_mesh(4, data_parallel=2,
                                               device="cpu"))
    with pytest.raises(ValueError, match="not divisible by data=2"):
        pipe.init_state(np.zeros((3, cfg.frame_bytes), np.uint8))
    st = pipe.init_state(np.zeros((2, cfg.frame_bytes), np.uint8))
    with pytest.raises(ValueError, match="need 2 texts"):
        pipe.step(st, np.zeros((2, cfg.frame_bytes), np.uint8),
                  text=["a", "b", "c"])
    jpipe = JaxSharded(jax_config(cfg), jax_make_mesh(4, data_parallel=2))
    with pytest.raises(ValueError, match="need 2 texts"):
        jpipe.step(jpipe.init_state(np.zeros((2, cfg.frame_bytes), np.uint8)),
                   np.zeros((2, cfg.frame_bytes), np.uint8),
                   text=["a", "b", "c"])


# -- the landing of padded shards (the unit-local narrowing hazard) -----------

@pytest.mark.parametrize("s,pad", [(2, 512), (4, 768), (8, 896)])
def test_padded_shards_land_exact(s, pad):
    """At 48x64 every shard pads to whole tiles (S = 2, 4, 8: 512, 768 and
    896 bytes), so unit ``t`` of the concatenated shards does not start at
    byte ``t * unit_bytes`` and a unit-local rebuild of the indices puts
    shard ``k`` off by ``k * pad``. The sharded executor lands each shard's
    span with its global int32 indices: its payloads equal step_oracle's
    and the JAX sharded executor's, frame for frame."""
    cfg = _cfg()
    pipe = ShardedDeltaPipeline(cfg, make_mesh(s, device="cpu"),
                                payload_layout="sharded")
    n_pad = logcompact.tiled_geometry(pipe.local_bytes, 0)[0]
    assert n_pad - pipe.local_bytes == pad
    src = SyntheticSource(cfg, seed=4)
    base = next(src)
    st = pipe.init_state_flat(base)
    _, counts, xs, vals, _ = pipe.step_flat(st, next(src))
    c = gather(counts).astype(np.int64)
    ub = xs[0].shape[1]
    naive = TiledLander.rebuild_xs(
        np.remainder(gather(xs), ub).astype(np.uint8), c, 0, ub)
    assert not np.array_equal(naive, gather(xs))  # the hazard is live here

    ex = ShardedStreamExecutor(cfg, mesh=make_mesh(s, device="cpu"))
    jex = jax_sharded_exec.ShardedStreamExecutor(
        jax_config(cfg), mesh=jax_sharded_exec.make_mesh(1, s))
    src, jsrc = SyntheticSource(cfg, seed=4), SyntheticSource(cfg, seed=4)
    prev = ex.start(next(src)).copy()
    jex.start(next(jsrc))
    for _ in range(4):
        frame = next(src)
        pos, tp, _, _ = ex.process(frame)
        jpos, jtp, _, _ = jex.process(next(jsrc))
        exp = ref.step_oracle(prev, frame, cfg)
        assert isinstance(tp, wire.TiledPayload) and pos == jpos == exp[1]
        xs_f, vals_f = tp.to_flat()
        _assert_same(xs_f, exp[2])
        _assert_same(vals_f, exp[3])
        jxs, jvals = jtp.to_flat()
        _assert_same(xs_f, np.asarray(jxs, np.int32))
        _assert_same(vals_f, np.asarray(jvals, np.uint8))
        prev = exp[0]
    assert ex.fetch_counts["tiles"] == 4  # pinned to tiles at S > 1


# -- the executors ------------------------------------------------------------

EXECS = [(s, layout, pipelined) for s in (1, 2, 4, 8)
         for layout in ("sharded", "replicated") for pipelined in (False, True)]


@pytest.mark.parametrize("s,layout,pipelined", EXECS,
                         ids=[f"S{s}-{lay}-{'pipelined' if p else 'sync'}"
                              for s, lay, p in EXECS])
def test_executor_matches_jax(s, layout, pipelined):
    """The sharded executors serve the JAX sharded executors' wire bytes
    (v1) frame for frame, with the aux frames of ``--visualizer 2``; the
    pipelined one lags a frame and lands the last on ``flush``."""
    cfg = _cfg(visualizer=Visualizer.RED_BLACK)
    cls = PipelinedShardedExecutor if pipelined else ShardedStreamExecutor
    jcls = (jax_sharded_exec.PipelinedShardedExecutor if pipelined
            else jax_sharded_exec.ShardedStreamExecutor)
    ex = cls(cfg, mesh=make_mesh(s, device="cpu"), payload_layout=layout)
    jex = jcls(jax_config(cfg), mesh=jax_sharded_exec.make_mesh(1, s),
               payload_layout=layout)
    src, jsrc = SyntheticSource(cfg, seed=8), SyntheticSource(cfg, seed=8)
    ex.start(next(src))
    jex.start(next(jsrc))
    got, want = [], []
    for k in range(5):
        text = f"T{k}"
        got.append(ex.process(next(src), text=text))
        want.append(jex.process(next(jsrc), text=text))
    got.append(ex.flush())
    want.append(jex.flush())
    got = [r for r in got if r is not None]
    want = [r for r in want if r is not None]
    assert len(got) == len(want) == 5
    for (pos, xs, vals, aux), (jpos, jxs, jvals, jaux) in zip(got, want):
        if vals is None:
            xs, vals = xs.to_flat()
        if jvals is None:
            jxs, jvals = jxs.to_flat()
        assert wire.pack_payload(pos, xs, vals) == jax_wire.pack_payload(
            jpos, np.asarray(jxs), np.asarray(jvals))
        _assert_same(aux, np.asarray(jaux))
    if layout == "sharded":
        assert sum(ex.fetch_counts.values()) == 5
    else:
        assert ex.fetch_counts == {}


# -- server --mesh over TCP -------------------------------------------------------

SERVE = [(pipelined, wire_format, kind) for pipelined in (False, True)
         for wire_format in ("v1", "v3") for kind in ("port", "jax")]


@pytest.mark.parametrize("pipelined,wire_format,client_kind", SERVE,
                         ids=[f"{'pipelined' if p else 'sync'}-{w}-{k}"
                              for p, w, k in SERVE])
def test_server_mesh_loopback(pipelined, wire_format, client_kind):
    """``server --mesh 1,4 --device cpu``, as ``server.setup`` builds it
    from the command line (``--pipelined``, ``--wire``), over a real
    socket: the port's client and the JAX client (wire auto) decode every
    frame equal to an oracle replay; every landing is a ``tiles`` one."""
    argv = ["--mesh", "1,4", "--device", "cpu", "--height", str(H),
            "--width", str(W), "--port", "0", "--wire", wire_format]
    cfg, ex, _ = server_mod.setup(argv + (["--pipelined"] if pipelined
                                           else []))
    assert isinstance(ex, PipelinedShardedExecutor if pipelined
                      else ShardedStreamExecutor)
    assert ex.pipe.n_space == 4 and ex.pipe.payload_layout == "sharded"
    n_frames = 5
    server = DeltaStreamServer(cfg, SyntheticSource(cfg, seed=3),
                               executor=ex, verbose=False,
                               overlay_status=False)
    t, errors = _serve_in_thread(server, n_frames)
    cli = _client(client_kind, server.port, cfg)
    cli.connect()
    states = _oracle_states(cfg, 3, n_frames)
    np.testing.assert_array_equal(cli.frame, states[0])
    got = _drain(cli)
    _join(t, [], errors)
    server.close()
    assert len(got) == n_frames and got[0][0] > 0
    for (_, recon), want in zip(got, states[1:]):
        np.testing.assert_array_equal(recon, want)
    assert ex.fetch_counts["tiles"] == n_frames


def test_server_mesh_threshold_map(tmp_path):
    """``--mesh 1,2 --threshold-map``: the map is cut along rows, and the
    served states are step_oracle(threshold_map=)'s."""
    path = tmp_path / "map.npy"
    tm2 = np.full((H, W), 40, np.uint8)
    tm2[10:30, 8:40] = 3
    np.save(path, tm2)
    cfg, ex, _ = server_mod.setup(["--mesh", "1,2", "--device", "cpu",
                                   "--height", str(H), "--width", str(W),
                                   "--threshold-map", str(path)])
    tm = np.repeat(tm2.ravel(), 3)
    _assert_same(ex.pipe.threshold_map_np, tm)
    src = SyntheticSource(cfg, seed=6)
    prev = ex.start(next(src)).copy()
    for _ in range(3):
        frame = next(src)
        pos, tp, _, _ = ex.process(frame)
        exp = ref.step_oracle(prev, frame, cfg, threshold_map=tm)
        assert pos == exp[1]
        _assert_same(tp.to_flat()[0], exp[2])
        prev = exp[0]


# -- multiserve --mesh over TCP ----------------------------------------------------

def _multi_mesh(cfg, n_streams, mesh, seed, cls=MultiStreamServer, **kw):
    if cls is MultiStreamServer:
        server = cls(cfg, [SyntheticSource(cfg, seed=seed + b)
                           for b in range(n_streams)], verbose=False,
                     overlay_status=False, mesh=make_mesh(
                         mesh[0] * mesh[1], data_parallel=mesh[0],
                         device="cpu"), **kw)
    else:
        jcfg = jax_config(cfg)
        server = cls(jcfg, [jax_sources.SyntheticSource(jcfg, seed=seed + b)
                            for b in range(n_streams)], verbose=False,
                     overlay_status=False,
                     mesh=jax_sharded_exec.make_mesh(*mesh), **kw)
    server._pending = [_SignalQueue() for _ in range(n_streams)]
    server.listen()
    return server


@pytest.mark.parametrize("client_kind", ["port", "jax"])
def test_multiserve_mesh_loopback(client_kind):
    """``multiserve --mesh 2,2`` with 4 streams, a client on each from the
    first frame: every decoded state equals the oracle replay of its
    stream's source; every stream lands through the ``shards`` flavor."""
    cfg = _cfg(wire_format="v3")
    n_frames = 4
    server = _multi_mesh(cfg, 4, (2, 2), seed=21)
    got = [[] for _ in range(4)]
    readers = [_decoder(client_kind, p, cfg, got[b])
               for b, p in enumerate(server.ports)]
    for q in server._pending:
        q.wait()
    t, errors = _serve(server, n_frames)
    _join(t, readers, errors)
    for b in range(4):
        src = SyntheticSource(cfg, seed=21 + b)
        prev = next(src).copy()
        want = [prev]
        for _ in range(n_frames):
            prev = ref.step_oracle(prev, next(src), cfg)[0]
            want.append(prev)
        assert len(got[b]) == n_frames + 1
        for g, w in zip(got[b], want):
            np.testing.assert_array_equal(g, w)
    assert server.fetch_counts["tiles"] == 4 * n_frames


def test_multiserve_mesh_wire_bytes_match_jax():
    """Raw readers on every stream of the port's ``multiserve --mesh 2,2``
    and of the JAX package's, on the same seeds: the same bytes."""
    cfg = _cfg()
    streams = []
    for cls in (MultiStreamServer, jax_multiserve.MultiStreamServer):
        server = _multi_mesh(cfg, 4, (2, 2), seed=31, cls=cls)
        raw = [bytearray() for _ in range(4)]
        readers = [_raw_reader(p, raw[b]) for b, p in enumerate(server.ports)]
        for q in server._pending:
            q.wait()
        t, errors = _serve(server, 3)
        _join(t, readers, errors)
        streams.append(raw)
    assert len(streams[0][0]) > cfg.frame_bytes
    assert streams[0] == streams[1]


def test_multiserve_mesh_main_aux_dir(tmp_path):
    """``multiserve --mesh 2,2 --visualizer 5 --aux-dir`` parsed by the
    port's command line: the aux frames of the first frame, one per
    stream, equal step_oracle's."""
    args = multiserve.parse_args(["--mesh", "2,2", "--device", "cpu",
                                  "--streams", "4", "--visualizer", "5"])
    assert args.mesh == (2, 2)
    cfg = _cfg(visualizer=Visualizer.BINARIZE)
    server = _multi_mesh(cfg, 4, args.mesh, seed=41, aux_dir=str(tmp_path))
    readers = [_raw_reader(p, bytearray()) for p in server.ports]
    for q in server._pending:
        q.wait()
    t, errors = _serve(server, 2)
    _join(t, readers, errors)
    for b in range(4):
        src = SyntheticSource(cfg, seed=41 + b)
        prev = next(src)
        exp = ref.step_oracle(prev, next(src), cfg)[4]
        with open(os.path.join(tmp_path, f"aux_{b}_000000.ppm"), "rb") as f:
            rgb = np.frombuffer(f.read()[-cfg.frame_bytes:], np.uint8)
        _assert_same(rgb.reshape(-1, 3)[:, ::-1].reshape(-1), exp)


# -- the JAX package's refusals ----------------------------------------------------

SERVER_REFUSALS = {
    "tiled": ["--tiled"], "oracle": ["--backend", "oracle"],
    "sort": ["--compaction", "sort"], "capacity": ["--capacity", "100"],
    "land-batch": ["--land-batch", "2"],
}


@pytest.mark.parametrize("flags", list(SERVER_REFUSALS.values()),
                         ids=list(SERVER_REFUSALS))
def test_server_mesh_refusals(flags):
    """``--mesh`` with ``--tiled``, ``--backend oracle``, ``--compaction``
    other than pallas, ``--capacity`` or ``--land-batch``: a usage error
    from both servers' command lines."""
    argv = ["--mesh", "1,1", "--height", str(H), "--width", str(W)] + flags
    with pytest.raises(SystemExit):
        jax_server.main(argv)
    with pytest.raises(SystemExit):
        server_mod.parse_args(argv + ["--device", "cpu"])


def test_mesh_construction_refusals():
    """The executor's, the pipeline's, the mesh's and multiserve's
    refusals, each as the JAX package makes it; a shard past int32, which
    goes to compact_sort, refused there as in the JAX package; and the
    port's own: a mesh on CUDA where there is none."""
    cfg, jcfg = _cfg(), jax_config(_cfg())
    for tiled, d, msg in ((True, 1, "single-chip emit mode"),
                          (False, 2, "data axis must be 1")):
        with pytest.raises(ValueError, match=msg):
            ShardedStreamExecutor(
                dataclasses.replace(cfg, tiled_payload=tiled),
                mesh=make_mesh(d, data_parallel=d, device="cpu"))
        with pytest.raises(ValueError, match=msg):
            jax_sharded_exec.ShardedStreamExecutor(
                dataclasses.replace(jcfg, tiled_payload=tiled),
                mesh=jax_sharded_exec.make_mesh(d, 1))
    cases = [
        (dict(payload_layout="x"), "unknown payload_layout", 2),
        ({}, "not divisible by space=5", 5),
        (dict(threshold_map=np.zeros(7, np.uint8)), "threshold_map has 7", 2),
    ]
    for kw, msg, s in cases:
        with pytest.raises(ValueError, match=msg):
            JaxSharded(jcfg, jax_make_mesh(s), **kw)
        with pytest.raises(ValueError, match=msg):
            ShardedDeltaPipeline(cfg, make_mesh(s, device="cpu"), **kw)
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        jax_make_mesh(9)
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="exceeds packed-key compaction"):
        ShardedDeltaPipeline(StreamConfig(height=2 ** 15, width=2 ** 15),
                             make_mesh(1, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1)
    with pytest.raises(ValueError, match="not divisible by data=2"):
        MultiStreamServer(cfg, [SyntheticSource(cfg)] * 3, verbose=False,
                          mesh=make_mesh(2, data_parallel=2, device="cpu"))
    with pytest.raises(ValueError, match="not divisible by data=2"):
        jax_multiserve.MultiStreamServer(
            jcfg, [jax_sources.SyntheticSource(jcfg)] * 3, verbose=False,
            mesh=jax_sharded_exec.make_mesh(2, 1))
    for mod in (jax_multiserve.main, multiserve.parse_args):
        with pytest.raises(SystemExit):
            mod(["--mesh", "1,1", "--capacity", "100", "--height", str(H),
                 "--width", str(W)])
    with pytest.raises(SystemExit):
        server_mod.parse_args(["--mesh", "2", "--device", "cpu"])
