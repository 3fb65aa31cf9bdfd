"""The port's served-path harnesses (``cudavideostream_tpu_torch/
loopback_sweep.py`` and ``loopback.py``) against the JAX package's
``benchmarks/loopback_sweep.py`` on the CPU at 48x64: the clustered
sources byte for byte, ``run_row``'s ``pos_mean`` and gate on rows of
every landing flavor, batched and HOST, the gate failing on a corrupted
client frame, and both mains. Also the two repairs the harness needs:
the lander's ``fetched_bytes`` and the server's static
``_send_payload``. Every socket carries a timeout and every thread is
joined with one.
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch

import benchmarks.loopback_sweep as jax_sweep
from cudavideostream_tpu.config import CompactionBackend as JaxBackend
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.models import DeltaStreamPipeline as JaxPipeline
from cudavideostream_tpu.runtime import executor as jax_executor
from cudavideostream_tpu_torch import loopback, loopback_sweep
from cudavideostream_tpu_torch.config import StreamConfig, Visualizer
from cudavideostream_tpu_torch.runtime import executor as executor_mod
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.executor import StreamExecutor
from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer

H, W = 48, 64
TIMEOUT = 60.0
GEO = {"height": H, "width": W, "overlay_scale": 1}
CFG = StreamConfig(**GEO)
DENSITIES = [0.01, 0.03, 0.06]
ROWS = {row[0]: row for row in loopback_sweep.MATRIX}
# a row of each landing flavor, batched rows, host capture and the HOST
# backend; the mask row is off the matrix (its v4 rows batch 16 at d = 1%)
GATED_ROWS = [ROWS[k] for k in (
    "dev_d3_tiles_v3", "dev_d3_flat_v3", "dev_d3_auto_v3",
    "dev_d3_tiles_v3_batch4", "dev_d1_maskonly_v4_batch8",
    "host_d1_tiles_v3", "hostbk_d1_v1")] + [
    ("dev_d1_mask_v4_batch8", "device", 0.01, "mask", "v4", "pallas", 8)]


@pytest.fixture
def timed_sockets():
    """Every socket made in the test (the JAX harness's among them)
    waits at most ``TIMEOUT`` on any one call."""
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(TIMEOUT)
    try:
        yield
    finally:
        socket.setdefaulttimeout(old)


def _jax_row(row, frames=10):
    """The JAX sweep's executor, source and ``run_row`` keywords for
    ``row``, as its ``main`` builds them on the CPU."""
    _, capture, density, fetch, wirefmt, backend, pipelined = row
    base = JaxConfig(tiled_payload=True, **GEO)
    depth = pipelined if isinstance(pipelined, int) \
        and not isinstance(pipelined, bool) else 0
    if backend == "host":
        cfg = JaxConfig(compaction=JaxBackend("host"), wire_format=wirefmt,
                        **GEO)
        ex = jax_executor.StreamExecutor(cfg)
    else:
        maskish = fetch in ("mask", "maskonly")
        cfg = dataclasses.replace(
            base, fetch_mode="mask" if maskish else fetch,
            wire_format=wirefmt, emit_bitmask=maskish,
            mask_payload=maskish and wirefmt == "v4",
            maskonly_payload=fetch == "maskonly")
        pipe = JaxPipeline(dataclasses.replace(
            base, emit_bitmask=maskish,
            fetch_mode="mask" if fetch == "maskonly" else base.fetch_mode,
            maskonly_payload=fetch == "maskonly"))
        if depth:
            ex = jax_executor.BatchedLandExecutor(cfg, pipeline=pipe,
                                                  depth=depth)
        else:
            ex = jax_executor.StreamExecutor(cfg, pipeline=pipe)
    src = (jax_sweep.DeviceClusteredSource(cfg, density)
           if capture == "device" else jax_sweep.HostClusteredSource(cfg,
                                                                    density))
    n, warm = frames, 2
    if depth:
        warm = 3 * depth
        n = max(6 * depth, (n + depth - 1) // depth * depth)
    return cfg, src, ex, {"n_frames": n, "warm": warm,
                          "batched": bool(depth)}


def _port_row(row, frames=10):
    base, host = loopback_sweep.base_configs("cpu")
    pipes = loopback_sweep.Pipelines(base, "cpu")
    row = ROWS[row] if isinstance(row, str) else row
    return loopback_sweep.make_row(row, base, host, pipes, frames, "cpu")


# -- the clustered sources ---------------------------------------------------


@pytest.mark.parametrize("density", DENSITIES)
def test_host_source_equals_jax(density):
    port = loopback_sweep.HostClusteredSource(CFG, density)
    ref = jax_sweep.HostClusteredSource(JaxConfig(**GEO), density)
    np.testing.assert_array_equal(port.base_frame(), ref.base_frame())
    for t in range(32):
        np.testing.assert_array_equal(next(port), next(ref), err_msg=str(t))


@pytest.mark.parametrize("density", DENSITIES)
def test_device_source_equals_host_and_jax(density):
    dev = loopback_sweep.DeviceClusteredSource(CFG, density, device="cpu")
    host = loopback_sweep.HostClusteredSource(CFG, density)
    ref = jax_sweep.DeviceClusteredSource(JaxConfig(**GEO), density)
    np.testing.assert_array_equal(dev.base_frame(), host.base_frame())
    frames = []
    for t in range(32):
        f = next(dev)
        assert isinstance(f, torch.Tensor) and f.dtype == torch.uint8
        assert f.shape == (CFG.frame_bytes,) and f.device.type == "cpu"
        want = next(host)
        np.testing.assert_array_equal(f.numpy(), want, err_msg=str(t))
        np.testing.assert_array_equal(f.numpy(), np.asarray(next(ref)),
                                      err_msg=str(t))
        frames.append(f)
    # a new tensor every frame, and the base left as it was
    assert len({f.data_ptr() for f in frames}) == len(frames)
    np.testing.assert_array_equal(dev._base.numpy(), host.base_frame())


def test_device_source_bands_wrap_and_drift():
    """The band is ``density * n`` bytes at ``4096 t`` modulo ``n -
    band``, +77 on even frames and +154 on odd ones, wrapping."""
    cfg = StreamConfig(height=96, width=128)
    src = loopback_sweep.DeviceClusteredSource(cfg, 0.03, device="cpu")
    base = src.base_frame().astype(np.int32)
    band = int(0.03 * cfg.frame_bytes)
    for t in range(8):
        f = next(src).numpy().astype(np.int32)
        start = (t * 4096) % (cfg.frame_bytes - band)
        changed = np.flatnonzero(f != base)
        assert changed.min() >= start and changed.max() < start + band
        d = (f - base) % 256
        assert set(np.unique(d[start:start + band])) == {77 if t % 2 == 0
                                                          else 154}


# -- run_row against the JAX harness -----------------------------------------


@pytest.mark.parametrize("row", GATED_ROWS, ids=[r[0] for r in GATED_ROWS])
def test_run_row_equals_jax(row, timed_sockets):
    cfg, ex, src, kw = _port_row(row)
    med, fps, pos_mean, ok, kb_pf = loopback_sweep.run_row(cfg, src, ex,
                                                           **kw)
    jcfg, jsrc, jex, jkw = _jax_row(row)
    _, _, jpos_mean, jok, _ = jax_sweep.run_row(jcfg, jsrc, jex, **jkw)
    assert ok and jok
    assert pos_mean == jpos_mean
    assert set(med) == {"capture", "dispatch", "land", "send", "total"}
    assert all(np.isfinite(v) and v >= 0 for v in med.values())
    assert fps == pytest.approx(1e3 / med["total"])
    # a lander fetched bytes on every tiled row; the HOST rows have none
    assert (kb_pf is None) == (row[5] == "host")


def test_gate_fails_on_a_corrupted_client_frame(monkeypatch, timed_sockets):
    real = loopback_sweep._client_thread

    def corrupt(*args):
        real(*args)
        out = args[-1]
        out["frame"][7] ^= 1

    monkeypatch.setattr(loopback_sweep, "_client_thread", corrupt)
    cfg, ex, src, kw = _port_row("dev_d3_tiles_v3")
    assert not loopback_sweep.run_row(cfg, src, ex, **kw)[3]


def test_run_row_legs_for_batched_rows_are_means(timed_sockets):
    """A batched row's window is whole batches after ``3 K`` warm-up
    frames, at least ``6 K`` frames; its land leg holds the landings."""
    cfg, ex, src, kw = _port_row("dev_d1_tiles_v3_batch4", frames=5)
    assert kw == {"n_frames": 24, "warm": 12, "pipelined": False,
                  "batched": True}
    med, *_ = loopback_sweep.run_row(cfg, src, ex, **kw)
    assert med["dispatch"] == 0.0 and med["land"] > 0.0
    assert ex.lander.fetch_counts["tiles"] == 36


# -- the mains ---------------------------------------------------------------


def test_sweep_main_runs_every_row_on_the_cpu(capsys, timed_sockets):
    assert loopback_sweep.main(["--device", "cpu", "--frames", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [line for line in out if not line.startswith("#")]
    assert [r.split()[0] for r in rows] == [m[0] for m in
                                            loopback_sweep.MATRIX]
    assert all(" OK" in r for r in rows)
    assert len(loopback_sweep.MATRIX) == 32
    assert sum(m[1] == "device" for m in loopback_sweep.MATRIX) == 28


def test_sweep_main_quick_rows_repeat_and_out(capsys, tmp_path,
                                              timed_sockets):
    out_file = tmp_path / "sweep.txt"
    argv = ["--device", "cpu", "--frames", "3", "--quick", "--repeat", "2",
            "--rows", "dev_d3_flat_v3,host_d1_tiles_v3,dev_d1_tiles_v3",
            "--out", str(out_file)]
    assert loopback_sweep.main(argv) == 0
    rows = [line.split()[0] for line in capsys.readouterr().out.splitlines()
            if not line.startswith("#")]
    # --quick drops the host rows; reps interleave in the matrix's order
    assert rows == ["dev_d3_flat_v3_rep0", "dev_d1_tiles_v3_rep0",
                    "dev_d3_flat_v3_rep1", "dev_d1_tiles_v3_rep1"]
    assert out_file.read_text().count("_rep") == 4


@pytest.mark.parametrize("failure", ["raises", "mismatch"])
def test_sweep_main_exits_non_zero_on_a_failed_row(failure, monkeypatch,
                                                   capsys, timed_sockets):
    real = loopback_sweep.run_row

    def run_row(cfg, source, executor, **kw):
        med, fps, pos_mean, ok, kb_pf = real(cfg, source, executor, **kw)
        if cfg.fetch_mode == "flat":
            if failure == "raises":
                raise RuntimeError("forced")
            ok = False
        return med, fps, pos_mean, ok, kb_pf

    monkeypatch.setattr(loopback_sweep, "run_row", run_row)
    argv = ["--device", "cpu", "--frames", "3", "--rows",
            "dev_d3_tiles_v3,dev_d3_flat_v3,dev_d1_tiles_v1"]
    assert loopback_sweep.main(argv) == 1
    lines = capsys.readouterr().out.splitlines()
    flat = next(line for line in lines if line.startswith("dev_d3_flat_v3"))
    assert ("FAILED: RuntimeError: forced" in flat if failure == "raises"
            else "MISMATCH" in flat)
    # the other rows still ran
    assert sum(" OK" in line for line in lines) == 2


def test_mains_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        loopback_sweep.main(["--frames", "1"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        loopback.main(["--frames", "1"])


def test_loopback_main_on_the_cpu(capsys, tmp_path, timed_sockets):
    out_file = tmp_path / "loop.tsv"
    assert loopback.main(["--device", "cpu", "--frames", "3",
                          "--out", str(out_file)]) == 0
    text = capsys.readouterr().out
    assert "48x64 on the CPU" in text
    names = [line.split("\t")[0]
             for line in out_file.read_text().splitlines()[1:]]
    assert names == ["cpu_oracle_diff_encode", "loop_oracle_backend",
                     "loop_device_backend", "loop_device_backend_wire_v2",
                     "loop_device_tiled_fetch_tiles",
                     "loop_device_tiled_fetch_flat",
                     "loop_device_tiled_fetch_auto"]


def test_loopback_rate_gates_the_client(monkeypatch, timed_sockets):
    """A served frame the client does not see makes the loop raise."""
    real = executor_mod.StreamExecutor._land

    def land(self, t0, staged):
        pos, xs, vals, aux = real(self, t0, staged)
        if pos:
            vals = vals.copy()
            vals[0] ^= 1
        return pos, xs, vals, aux

    monkeypatch.setattr(executor_mod.StreamExecutor, "_land", land)
    with pytest.raises(AssertionError, match="not the server's state"):
        loopback.loopback_rate(H, W, 3, "device", device="cpu")


# -- TiledLander.fetched_bytes -----------------------------------------------


@pytest.mark.parametrize("fetch", ["tiles", "flat", "mask", "maskonly"])
@pytest.mark.parametrize("vis", [Visualizer.NONE, Visualizer.HEATMAP])
def test_fetched_bytes_counts_each_landing_copy(fetch, vis, monkeypatch):
    """``fetched_bytes`` adds the host bytes of every payload copy a
    landing makes, and not the aux frame that rides along."""
    copied = []
    real_run = executor_mod._Copier.run

    def run(self, staged, fn):
        aux = self._aux(staged)
        host = real_run(self, staged, fn)
        copied.append(sum(a.nbytes for a in host))
        # the aux frame was copied too, and left out of the result
        assert (staged.aux_host is not None) == bool(aux)
        return host

    monkeypatch.setattr(executor_mod._Copier, "run", run)
    maskish = fetch in ("mask", "maskonly")
    cfg = StreamConfig(tiled_payload=True, visualizer=vis,
                       fetch_mode="mask" if maskish else fetch,
                       emit_bitmask=maskish, maskonly_payload=fetch ==
                       "maskonly", **GEO)
    ex = StreamExecutor(cfg, device="cpu")
    src = loopback_sweep.HostClusteredSource(cfg, 0.03)
    ex.start(src.base_frame())
    pos, xs, vals, aux = ex.process(next(src))
    assert pos > 0 and len(copied) == 1
    assert ex.lander.fetched_bytes == copied[0]
    if fetch == "flat":
        assert copied[0] == xs.nbytes + vals.nbytes == 5 * pos
    assert (aux is not None) == (vis is not Visualizer.NONE)
    ex.process(next(src))
    assert ex.lander.fetched_bytes == sum(copied) and len(copied) == 2


def test_fetched_bytes_is_the_same_on_two_runs(timed_sockets):
    got = []
    for _ in range(2):
        cfg, ex, src, kw = _port_row("dev_d3_flat_v3")
        _, _, pos_mean, ok, kb_pf = loopback_sweep.run_row(cfg, src, ex, **kw)
        assert ok
        got.append((kb_pf, ex.lander.fetched_bytes))
        # every flat landing copies 5 B an entry, xs and vals
        frames = kw["warm"] + kw["n_frames"]
        assert ex.lander.fetched_bytes == pytest.approx(5 * pos_mean * frames)
    assert got[0] == got[1]


# -- DeltaStreamServer._send_payload -----------------------------------------


def _payloads():
    """One landed result of each type: flat arrays, a TiledPayload and a
    MaskPayload, with the base frame they were made against."""
    out = {}
    for kind, fetch in (("flat", "flat"), ("tiled", "tiles"),
                        ("mask", "mask")):
        cfg = StreamConfig(tiled_payload=True, fetch_mode=fetch,
                           emit_bitmask=fetch == "mask",
                           mask_payload=fetch == "mask", **GEO)
        ex = StreamExecutor(cfg, device="cpu")
        src = loopback_sweep.HostClusteredSource(cfg, 0.03)
        base = ex.start(src.base_frame())
        out[kind] = (base, ex.process(next(src)))
    assert isinstance(out["tiled"][1][1], wire.TiledPayload)
    assert isinstance(out["mask"][1][1], wire.MaskPayload)
    return out


def _expected(wirefmt, base, result):
    """The wire bytes of ``result`` from the packers, as ``_send`` sent
    them: v1 the reference framing, v2 delta16, v3/v4 the encoders."""
    pos, xs, vals, _ = result
    if wirefmt == "v3":
        return wire.V3Encoder(base).encode(pos, xs, vals)
    if wirefmt == "v4":
        return wire.V4Encoder(base).encode(pos, xs, vals)
    if isinstance(xs, (wire.TiledPayload, wire.MaskPayload)):
        xs, vals = xs.to_flat()
    if wirefmt == "v2":
        return wire.pack_payload_v2(pos, xs, vals)
    return wire.pack_payload(pos, xs, vals)


def _received(send):
    a, b = socket.socketpair()
    a.settimeout(TIMEOUT)
    b.settimeout(TIMEOUT)
    with a, b:
        ret = send(a)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while chunk := b.recv(1 << 16):
            chunks.append(chunk)
    return ret, b"".join(chunks)


@pytest.mark.parametrize("wirefmt", ["v1", "v2", "v3", "v4"])
@pytest.mark.parametrize("kind", ["flat", "tiled", "mask"])
def test_send_payload_sends_what_send_sent(kind, wirefmt):
    base, result = _payloads()[kind]
    want = _expected(wirefmt, base, result)
    enc = {"v3": wire.V3Encoder, "v4": wire.V4Encoder}.get(wirefmt)
    sent, got = _received(lambda c: DeltaStreamServer._send_payload(
        c, result, wirefmt, enc(base) if enc else None))
    assert got == want and sent == len(want)
    # the instance's _send sends the same bytes and counts them
    cfg = StreamConfig(wire_format=wirefmt, **GEO)
    server = DeltaStreamServer(cfg, source=None,
                               executor=StreamExecutor(cfg, device="cpu"),
                               verbose=False)
    before = server.executor.metrics.wire_bytes
    ret, got = _received(lambda c: server._send(
        c, result, enc(base) if enc else None))
    assert ret is None and got == want and server._n_out == 1
    assert server.executor.metrics.wire_bytes - before == len(want) - (
        4 + 5 * result[0])
