"""The port's SORT and HOST compaction backends on the CPU against the JAX
pipelines of the same backend and against ``step_oracle``: the fast HOST
path (only the change bitmask leaves the device) and the noise-filter
path (the dense delta too), with and without negative feedback, with
overlay text and visualizers; the overflow with its ``state``, the
batched refusal of HOST and the batched SORT step; and both backends
served through the port's executor and server to a loopback client.
Every socket has a timeout and every thread is joined with one."""

import dataclasses
import functools
import socket
import threading

import numpy as np
import pytest
import torch

from conftest import ScriptedSource
from cudavideostream_tpu.config import CompactionBackend as JaxBackend
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.config import Visualizer as JaxVisualizer
from cudavideostream_tpu.models import DeltaStreamPipeline as JaxPipeline
from cudavideostream_tpu_torch.config import (
    CompactionBackend,
    PayloadOverflowError,
    StreamConfig,
    Visualizer,
)
from cudavideostream_tpu_torch.models import DeltaStreamPipeline
from cudavideostream_tpu_torch.models.batched import BatchedDeltaPipeline
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
from cudavideostream_tpu_torch.runtime.executor import StreamExecutor
from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer
from cudavideostream_tpu_torch.utils import fonts

H, W = 48, 64
TIMEOUT = 30
TEXTS = ["", "HI 42", "HI 42", "FPS: 7"]


@pytest.fixture(autouse=True)
def timed_connections(monkeypatch):
    """Every client socket opened through ``create_connection`` gets the
    test's timeout."""
    monkeypatch.setattr(socket, "create_connection", functools.partial(
        socket.create_connection, timeout=TIMEOUT))


def _cfg(backend, **kw):
    return StreamConfig(height=H, width=W, overlay_scale=4, port=0,
                        compaction=CompactionBackend(backend), **kw)


def jax_config(cfg) -> JaxConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JaxConfig)
          if f.name not in ("visualizer", "compaction")}
    return JaxConfig(visualizer=JaxVisualizer(cfg.visualizer.value),
                     compaction=JaxBackend(cfg.compaction.value), **kw)


def _frames(seed, n=len(TEXTS)):
    """A base frame and ``n`` frames: noise below the threshold on every
    byte, and large changes on a growing share of them."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, H * W * 3, dtype=np.uint8)
    frames, prev = [], base
    for k in range(n):
        cur = prev.astype(np.int16) + rng.integers(-12, 13, prev.size)
        big = rng.random(prev.size) < 0.06 * (k + 1)
        cur = np.where(big, cur + rng.integers(30, 120, prev.size), cur)
        prev = (cur % 256).astype(np.uint8)
        frames.append(prev)
    return base, frames


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


PATHS = {
    f"{backend}_{path}_{'negfeed' if nf else 'plain'}_vis{vis}": (
        backend, path == "denoise", nf, vis)
    for backend in ("sort", "host")
    for path in ("fast", "denoise")
    for nf in (True, False)
    for vis in (0, 3)
}
PATHS.update({f"host_fast_negfeed_vis{vis}": ("host", False, True, vis)
              for vis in (1, 2, 4, 5)})
PATHS["sort_fast_negfeed_vis1"] = ("sort", False, True, 1)


@pytest.mark.parametrize("name", list(PATHS))
def test_dense_backends_match_jax_and_oracle(name):
    """Four steps with overlay texts: ``pos``, the payload, the new state
    and the aux frame equal the JAX pipeline's of the same backend and
    ``step_oracle``'s. SORT's full ``capacity``-long arrays (zero past
    ``pos``) equal the JAX ones; HOST's host arrays are ``pos`` long."""
    backend, denoise, nf, vis = PATHS[name]
    cfg = _cfg(backend, noise_filter=denoise, negative_feedback=nf,
               visualizer=Visualizer(vis))
    base, frames = _frames(seed=len(name))
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    jpipe = JaxPipeline(jax_config(cfg))
    prev, jprev, oprev = pipe.init_state(base), jpipe.init_state(base), base
    for frame, text in zip(frames, TEXTS):
        out = pipe.step(prev, frame, text=text)
        jout = jpipe.step(jprev, frame, text=text)
        jprev = jout[0]
        oprev, opos, oxs, ovals, oaux = ref.step_oracle(
            oprev, frame, cfg, atlas=pipe.atlas_np,
            char_ids=fonts.encode_text(text),
            conv_weights=ref.gaussian_kernel(cfg.conv_k))
        assert out[0] is prev  # the state is updated in place
        pos = int(out[1])
        assert pos == int(jout[1]) == opos
        np.testing.assert_array_equal(prev.numpy(), np.asarray(jout[0]))
        np.testing.assert_array_equal(prev.numpy(), oprev)
        xs, vals = _host(out[2]), _host(out[3])
        if backend == "host":
            assert xs.size == vals.size == pos
        else:
            np.testing.assert_array_equal(xs, np.asarray(jout[2]))
            np.testing.assert_array_equal(vals, np.asarray(jout[3]))
        np.testing.assert_array_equal(xs[:pos], oxs)
        np.testing.assert_array_equal(vals[:pos], ovals)
        if vis:
            np.testing.assert_array_equal(out[4].numpy(), np.asarray(jout[4]))
            np.testing.assert_array_equal(out[4].numpy(), oaux)
        else:
            assert out[4] is None and jout[4] is None


@pytest.mark.parametrize("denoise", [False, True], ids=["fast", "denoise"])
def test_host_fetches_the_bitmask_only_on_the_fast_path(denoise):
    """The fast path brings the n/8-byte bitmask from the device and
    nothing else; under the noise filter, the dense delta as well."""
    cfg = _cfg("host", noise_filter=denoise)
    base, frames = _frames(seed=3)
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    prev = pipe.init_state(base)
    pipe.step(prev, frames[0], text="AB")
    n = cfg.frame_bytes
    assert pipe.last_fetch_bytes == (n + (n + 7) // 8 if denoise
                                     else (n + 7) // 8)


@pytest.mark.parametrize("nf", [True, False], ids=["negfeed", "plain"])
def test_host_takes_a_tensor_frame(nf):
    """A frame given as a tensor goes to the host with ``.cpu()``, as the
    JAX step's ``np.asarray`` brings it: the same payloads as the array,
    and the frame is not written."""
    cfg = _cfg("host", negative_feedback=nf)
    base, frames = _frames(seed=4)
    a, b = (DeltaStreamPipeline(cfg, device="cpu") for _ in range(2))
    pa, pb = a.init_state(base), b.init_state(base)
    for frame, text in zip(frames, TEXTS):
        t = torch.from_numpy(frame.copy())
        oa, ob = a.step(pa, frame, text=text), b.step(pb, t, text=text)
        assert oa[1] == ob[1]
        for x, y in zip(oa[2:4], ob[2:4]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(t.numpy(), frame)
    np.testing.assert_array_equal(pa.numpy(), pb.numpy())


def test_host_needs_init_state():
    """The fast path's host shadow comes from ``init_state``: a step
    without it raises, as in the JAX pipeline."""
    cfg = _cfg("host")
    base, frames = _frames(seed=5)
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    prev = torch.from_numpy(base.copy())
    with pytest.raises(RuntimeError, match="init_state"):
        pipe.step(prev, frames[0])
    # the noise-filter path keeps no shadow
    pipe = DeltaStreamPipeline(_cfg("host", noise_filter=True), device="cpu")
    assert int(pipe.step(prev, frames[0])[1]) > 0


@pytest.mark.parametrize("backend,denoise", [("host", False), ("host", True),
                                             ("sort", False)])
def test_overflow_carries_the_state(backend, denoise):
    """A frame past ``payload_capacity``: the HOST step raises
    ``PayloadOverflowError`` with the advanced state as ``state``, as the
    JAX step does; under either backend the executor's state has taken
    the frame, and its resync is the oracle's new state."""
    base, frames = _frames(seed=6)
    cfg = _cfg(backend, noise_filter=denoise, payload_capacity=10)
    want = ref.step_oracle(base, frames[0], cfg,
                           conv_weights=ref.gaussian_kernel(cfg.conv_k))[0]
    if backend == "host":
        pipe = DeltaStreamPipeline(cfg, device="cpu")
        jpipe = JaxPipeline(jax_config(cfg))
        prev = pipe.init_state(base)
        with pytest.raises(PayloadOverflowError) as got:
            pipe.step(prev, frames[0])
        from cudavideostream_tpu.config import \
            PayloadOverflowError as JaxOverflow
        with pytest.raises(JaxOverflow) as jgot:
            jpipe.step(jpipe.init_state(base), frames[0])
        assert got.value.state is prev
        np.testing.assert_array_equal(got.value.state.numpy(), want)
        np.testing.assert_array_equal(np.asarray(jgot.value.state), want)
    ex = StreamExecutor(cfg, device="cpu")
    ex.start(base)
    with pytest.raises(PayloadOverflowError):
        ex.process(frames[0])
    np.testing.assert_array_equal(ex.resync(), want)


def test_batched_refuses_host_and_runs_sort_per_stream():
    """``BatchedDeltaPipeline`` refuses HOST with the JAX package's
    ``ValueError``; under SORT each stream's outputs equal a solo step's
    and the oracle's."""
    from cudavideostream_tpu.models.batched import \
        BatchedDeltaPipeline as JaxBatched

    with pytest.raises(ValueError, match="HOST compaction packs per stream"):
        BatchedDeltaPipeline(_cfg("host"), 2, device="cpu")
    with pytest.raises(ValueError, match="HOST compaction packs per stream"):
        JaxBatched(jax_config(_cfg("host")), 2)
    cfg = _cfg("sort", visualizer=Visualizer.RED_BLACK)
    (b0, f0), (b1, f1) = _frames(seed=7), _frames(seed=8)
    pipe = BatchedDeltaPipeline(cfg, 2, device="cpu")
    prev = pipe.init_state(np.stack([b0, b1]))
    states = [b0, b1]
    n = cfg.frame_bytes
    for k, texts in enumerate([["A", ""], ["", "B1"], ["C", "C"]]):
        out = pipe.step(prev, np.stack([f0[k], f1[k]]), texts)
        for s in range(2):
            states[s], pos, xs, vals, aux = ref.step_oracle(
                states[s], (f0, f1)[s][k], cfg, atlas=pipe.atlas_np,
                char_ids=fonts.encode_text(texts[s]))
            assert int(out[1][s]) == pos
            np.testing.assert_array_equal(out[2][s][:pos].numpy(), xs)
            np.testing.assert_array_equal(out[3][s][:pos].numpy(), vals)
            np.testing.assert_array_equal(prev[s * n:(s + 1) * n].numpy(),
                                          states[s])
            np.testing.assert_array_equal(
                out[4][s * n:(s + 1) * n].numpy(), aux)


def _serve(cfg, base, frames, wire):
    """Serve the frames through the port's executor and server to the
    port's client; returns every state the client rebuilt."""
    cfg = dataclasses.replace(cfg, wire_format=wire)
    server = DeltaStreamServer(cfg, ScriptedSource(base, frames),
                               executor=StreamExecutor(cfg, device="cpu"),
                               verbose=False, overlay_status=False)
    server.listen()
    errors = []

    def run():
        try:
            server.serve()
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    cli = DeltaStreamClient("127.0.0.1", server.port, H, W)
    cli.connect()
    got = [cli.frame.copy()]
    try:
        while True:
            got.append(cli.read_frame()[1].copy())
    except ConnectionError:
        pass
    cli.close()
    t.join(TIMEOUT)
    server.close()
    assert not t.is_alive() and not errors, errors
    return got


@pytest.mark.parametrize("wire", ["v1", "v3"])
@pytest.mark.parametrize("backend", ["sort", "host"])
def test_served_byte_exact(backend, wire):
    """The executor lands each backend's payload (HOST's host arrays as
    they are) and the server ships it: the client's every state equals
    the oracle's."""
    cfg = _cfg(backend)
    base, frames = _frames(seed=9)
    got = _serve(cfg, base, frames, wire)
    want = [base]
    for frame in frames:
        want.append(ref.step_oracle(want[-1], frame, cfg)[0])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_served_overflow_resyncs_under_v3():
    """Under wire v3 a HOST frame past the capacity ships as one raw frame
    of the advanced state, and the stream goes on byte-exact."""
    cfg = _cfg("host", payload_capacity=64)
    base, frames = _frames(seed=10)
    got = _serve(cfg, base, frames, "v3")
    want = [base]
    for frame in frames:
        want.append(ref.step_oracle(want[-1], frame, cfg)[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

