"""The port's checkpoint and warm start on the CPU against the JAX
package's: ``.npz`` state files and link-cache files written by either
package load in the other; the refusals (geometry, threshold, negative
feedback; a mismatched, missing or corrupt cache, and ``NaN``,
``Infinity`` or ``-1`` values, each returning False and changing
nothing); ``calibrate_link`` and ``prewarm_fetch``; and ``server.main``'s
``--save-state``/``--resume`` and ``--link-cache``/``--calibrate`` and
``broadcast.main``'s ``--link-cache``, served to loopback clients
byte-exact against ``step_oracle``. Every socket has a timeout and every
thread is joined with one."""

import dataclasses
import functools
import json
import socket
import threading

import numpy as np
import pytest

from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.runtime.executor import \
    StreamExecutor as JaxExecutor
from cudavideostream_tpu_torch.config import CompactionBackend, StreamConfig
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.runtime import broadcast
from cudavideostream_tpu_torch.runtime import server as server_mod
from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
from cudavideostream_tpu_torch.runtime.executor import (
    ExecMetrics,
    PipelinedExecutor,
    StreamExecutor,
)
from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

H, W = 48, 64
TIMEOUT = 30


@pytest.fixture(autouse=True)
def timed_connections(monkeypatch):
    monkeypatch.setattr(socket, "create_connection", functools.partial(
        socket.create_connection, timeout=TIMEOUT))


def _cfg(**kw):
    return StreamConfig(**{"height": H, "width": W, "overlay_scale": 4, **kw})


def jax_config(cfg) -> JaxConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JaxConfig)
          if f.name not in ("visualizer", "compaction")}
    return JaxConfig(**kw)


def _run(ex, n, seed=1):
    """Start ``ex`` on a synthetic scene and serve it ``n`` frames."""
    src = SyntheticSource(StreamConfig(height=H, width=W), seed=seed)
    ex.start(src.base_frame())
    for _ in range(n):
        ex.process(next(src))
    return src


# -- the state file ---------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("backend", ["pallas", "host"])
def test_state_file_cross_loads(writer, backend, tmp_path):
    """A state written by either package loads in the other (and in its
    own): the loaded state is the writer's, and both go on with equal
    payloads. Under HOST, ``load_state`` resyncs the host shadow."""
    cfg = _cfg(compaction=CompactionBackend(backend))
    ours, theirs = StreamExecutor(cfg, device="cpu"), JaxExecutor(jax_config(
        dataclasses.replace(cfg, compaction=StreamConfig().compaction)))
    src = _run(ours if writer == "port" else theirs, 3)
    path = str(tmp_path / "state")
    (ours if writer == "port" else theirs).save_state(path)
    saved = np.load(path + ".npz")
    assert sorted(saved.files) == ["geometry", "negative_feedback", "prev",
                                   "threshold"]
    ours2, theirs2 = StreamExecutor(cfg, device="cpu"), JaxExecutor(
        theirs.cfg)
    ours2.load_state(path + ".npz")
    theirs2.load_state(path)
    np.testing.assert_array_equal(ours2.resync(), saved["prev"])
    np.testing.assert_array_equal(theirs2.resync(), saved["prev"])
    for k in range(3):
        frame = next(src)
        got, want = ours2.process(frame), theirs2.process(frame)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("change,msg", [
    (dict(height=24), "geometry mismatch"),
    (dict(threshold=21), "threshold 20 != config threshold 21"),
    (dict(negative_feedback=False), "negative_feedback mismatch"),
], ids=["geometry", "threshold", "negative_feedback"])
def test_state_file_refusals_match_jax(change, msg, tmp_path):
    """The three refusals of the JAX ``load_state``, with its messages, on
    a file from either package; nothing changes."""
    ex = StreamExecutor(_cfg(), device="cpu")
    _run(ex, 2)
    path = str(tmp_path / "s.npz")
    ex.save_state(path)
    other = StreamExecutor(_cfg(**change), device="cpu")
    jother = JaxExecutor(jax_config(_cfg(**change)))
    with pytest.raises(ValueError, match=msg):
        other.load_state(path)
    with pytest.raises(ValueError, match=msg):
        jother.load_state(path)
    assert other._state is None


def test_save_state_needs_a_state(tmp_path):
    with pytest.raises(RuntimeError, match="no state to save"):
        StreamExecutor(_cfg(), device="cpu").save_state(str(tmp_path / "s"))


# -- the link cache ---------------------------------------------------------

def _learned(cfg, n=6):
    """A port executor whose lander has measured every offered flavor."""
    ex = StreamExecutor(cfg, device="cpu")
    _run(ex, n)
    return ex


TILED = dict(tiled_payload=True, emit_bitmask=True)


@pytest.mark.parametrize("cfg_kw", [{}, TILED], ids=["flat", "tiled"])
def test_link_cache_port_to_jax(cfg_kw, tmp_path):
    """The port's file has the JAX keys and fingerprint; the JAX executor
    loads it without raising and takes its rate."""
    cfg = _cfg(**cfg_kw)
    ex = _learned(cfg)
    ex.calibrate_link(rounds=2)
    path = str(tmp_path / "link.json")
    ex.save_link_cache(path)
    data = json.load(open(path))
    assert set(data) == {"version", "fingerprint", "bps", "merge_s",
                         "lander"}
    jex = JaxExecutor(jax_config(cfg))
    assert data["fingerprint"] == jex._link_fingerprint()
    assert jex.load_link_cache(path) is True
    assert jex.link.bps == pytest.approx(data["bps"])
    fresh = StreamExecutor(cfg, device="cpu")
    assert fresh.load_link_cache(path) is True
    assert fresh.copy_rate == ex.copy_rate
    if cfg.tiled_payload:
        assert fresh.lander.extra_s == ex.lander.extra_s


@pytest.mark.parametrize("cfg_kw", [{}, TILED], ids=["flat", "tiled"])
def test_link_cache_jax_to_port(cfg_kw, tmp_path):
    """A JAX file (its lander's keys are the JAX lander's, ignored here)
    loads in the port: its measured rate seeds the copy rate."""
    cfg = _cfg(**cfg_kw)
    jex = JaxExecutor(jax_config(cfg))
    jex.calibrate_link(rounds=2)
    path = str(tmp_path / "link.json")
    jex.save_link_cache(path)
    ex = StreamExecutor(cfg, device="cpu")
    assert ex.load_link_cache(path) is True
    assert ex.copy_rate == pytest.approx(jex.link.bps)
    if cfg.tiled_payload:
        assert ex.lander.copy_bytes_per_s == ex.copy_rate
        assert ex.lander.extra_s == {"flat": None, "mask": None}


def _bad_files():
    cases = {"missing": None, "corrupt": "{not json", "empty": ""}
    for key in ("bps", "merge_s", "flat_extra"):
        for bad in ("NaN", "Infinity", "-1"):
            cases[f"{key}_{bad}"] = (key, bad)
    cases["bps_absent"] = ("bps", None)
    cases["bps_zero"] = ("bps", "0")
    cases["bps_text"] = ("bps", '"fast"')
    cases["version"] = ("version", "2")
    cases["fingerprint"] = ("fingerprint", "[1, 2]")
    cases["lander_list"] = ("lander", "[]")
    return cases


BAD = _bad_files()


@pytest.mark.parametrize("case", list(BAD))
def test_link_cache_refusals_change_nothing(case, tmp_path):
    """Each bad file returns False and leaves the rate and the extra times
    as they were."""
    cfg = _cfg(**TILED)
    ex = _learned(cfg)
    good = str(tmp_path / "good.json")
    ex.save_link_cache(good)
    path = tmp_path / "bad.json"
    spec = BAD[case]
    if isinstance(spec, str):
        path.write_text(spec)
    elif spec is not None:
        key, value = spec
        data = json.load(open(good))
        data["lander"]["extra_s"]["flat"] = 0.001
        text = json.dumps(data)
        target = ('"flat": 0.001' if key == "flat_extra"
                  else f'"{key}": {json.dumps(data[key])}')
        assert target in text
        if value is None:
            del data[key]
            text = json.dumps(data)
        else:
            name = "flat" if key == "flat_extra" else key
            text = text.replace(target, f'"{name}": {value}')
        path.write_text(text)
    fresh = StreamExecutor(cfg, device="cpu")
    fresh.lander.copy_bytes_per_s = 123.0
    fresh.lander.extra_s = {"flat": 0.5, "mask": None}
    before = (fresh.copy_rate, dict(fresh.lander.extra_s))
    assert fresh.load_link_cache(str(path)) is False
    assert (fresh.copy_rate, dict(fresh.lander.extra_s)) == before


def test_calibrate_seeds_the_copy_rate():
    """``calibrate_link`` times copies and folds them into the rate the
    lander learns (``auto``'s ``tiles`` flavor counts as measured)."""
    for kw in ({}, TILED):
        ex = StreamExecutor(_cfg(**kw), device="cpu")
        assert ex.copy_rate is None
        rate = ex.calibrate_link(rounds=2, nbytes=1 << 16)
        assert rate == ex.copy_rate and rate > 0
        if kw:
            assert ex.lander.copy_bytes_per_s == rate
            assert ex.lander._measured("tiles")
        assert ex.calibrate_link(rounds=0) == rate  # no copies timed


def test_prewarm_fetch_is_a_no_op():
    """Eager torch compiles nothing per slice length: ``prewarm_fetch``
    runs no step, needs no state and returns 0."""
    ex = StreamExecutor(_cfg(**TILED), device="cpu")
    steps = []
    ex.pipe.step = lambda *a, **kw: steps.append(a)
    assert ex.prewarm_fetch() == 0
    assert not steps and ex._state is None


# -- the command lines ------------------------------------------------------

def _serve_main(main, argv):
    errors = []

    def run():
        try:
            main(argv)
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, errors


def _client(port):
    for _ in range(2000):
        cli = DeltaStreamClient("127.0.0.1", port, H, W)
        try:
            cli.connect()
            return cli
        except ConnectionRefusedError:
            threading.Event().wait(0.01)
    raise AssertionError(f"nothing listens on {port}")


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _drain(cli):
    got = []
    try:
        while True:
            got.append(cli.read_frame()[1].copy())
    except ConnectionError:
        pass
    cli.close()
    return got


@pytest.mark.parametrize("flags", [[], ["--compaction", "host"],
                                   ["--tiled", "--pipelined"]],
                         ids=["pallas", "host", "tiled_pipelined"])
def test_server_save_state_then_resume(flags, tmp_path, monkeypatch):
    """``server.main --save-state`` after 3 frames, then a second server
    ``--resume``: its client's base frame is the saved state, and its
    states go on as ``step_oracle`` from there over the second source."""
    monkeypatch.setattr(ExecMetrics, "status_line", lambda self, *a: None)
    ckpt = str(tmp_path / "ckpt.npz")
    base = ["--device", "cpu", "--height", str(H), "--width", str(W),
            "--frames", "3"] + flags
    port = _port()
    t, errors = _serve_main(server_mod.main, base + [
        "--port", str(port), "--seed", "2", "--save-state", ckpt])
    first = _drain(_client(port))
    t.join(TIMEOUT)
    assert not t.is_alive() and not errors, errors
    saved = np.load(ckpt)["prev"]
    np.testing.assert_array_equal(first[-1], saved)
    port = _port()
    t, errors = _serve_main(server_mod.main, base + [
        "--port", str(port), "--seed", "4", "--resume", ckpt])
    cli = _client(port)
    np.testing.assert_array_equal(cli.frame, saved)
    got = _drain(cli)
    t.join(TIMEOUT)
    assert not t.is_alive() and not errors, errors
    cfg = StreamConfig(height=H, width=W)
    src = SyntheticSource(cfg, seed=4)
    # the resumed server takes no base frame: its first frame is the
    # source's first
    state = saved
    assert len(got) == 3
    for g in got:
        state = ref.step_oracle(state, next(src), cfg)[0]
        np.testing.assert_array_equal(g, state)


def test_resume_needs_a_checkpointable_executor(capsys, tmp_path):
    for flags in (["--mesh", "1,1"], ["--backend", "oracle"]):
        with pytest.raises(SystemExit):
            server_mod.setup(["--device", "cpu", "--height", str(H),
                              "--width", str(W), "--resume",
                              str(tmp_path / "x.npz")] + flags)
        assert "checkpointable executor" in capsys.readouterr().err


@pytest.mark.parametrize("main", ["server", "broadcast"])
def test_link_cache_written_and_reloaded(main, tmp_path, monkeypatch,
                                         capsys):
    """A first run writes ``--link-cache`` after serving; a second run with
    ``--calibrate 0`` loads it, so its lander starts from the saved rate
    before any frame lands; its stream stays byte-exact."""
    monkeypatch.setattr(ExecMetrics, "status_line", lambda self, *a: None)
    module = {"server": server_mod, "broadcast": broadcast}[main]
    cache = str(tmp_path / "link.json")
    loaded = []
    real_load = StreamExecutor.load_link_cache

    def load(self, path):
        ok = real_load(self, path)
        loaded.append((ok, self.lander.copy_bytes_per_s))
        return ok

    monkeypatch.setattr(StreamExecutor, "load_link_cache", load)
    rates = []
    for run in range(2):
        port = _port()
        argv = ["--device", "cpu", "--height", str(H), "--width", str(W),
                "--frames", "6", "--port", str(port), "--tiled",
                "--link-cache", cache] + (["--calibrate", "0"] if run else [])
        t, errors = _serve_main(module.main, argv)
        got = _drain(_client(port))
        t.join(TIMEOUT)
        assert not t.is_alive() and not errors, errors
        assert len(got) == 6
        rates.append(json.load(open(cache))["bps"])
    assert loaded[0][0] is False  # no file yet
    assert loaded[1] == (True, rates[0])
    err = capsys.readouterr().err
    assert "calibrated copy rate" in err and "link cache loaded" in err


def test_calibrate_prints_the_rate(capsys):
    """``--calibrate 2`` (the default) on a device executor prints the
    measured copy rate; ``--calibrate 0`` times nothing."""
    argv = ["--device", "cpu", "--height", str(H), "--width", str(W)]
    _, ex, _, _ = server_mod.setup(argv)
    assert ex.copy_rate > 0
    assert "calibrated copy rate" in capsys.readouterr().err
    _, ex, _, _ = server_mod.setup(argv + ["--calibrate", "0",
                                          "--pipelined"])
    assert isinstance(ex, PipelinedExecutor) and ex.copy_rate is None
    assert "calibrated" not in capsys.readouterr().err


def test_copy_of_a_cache_keeps_its_values(tmp_path):
    """Saving, loading and saving again writes the same values."""
    cfg = _cfg(**TILED)
    ex = _learned(cfg)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    ex.save_link_cache(a)
    other = StreamExecutor(cfg, device="cpu")
    assert other.load_link_cache(a)
    other.save_link_cache(b)
    assert json.load(open(a)) == json.load(open(b))
