"""The port's headline bench (``cudavideostream_tpu_torch/bench.py``) on
the CPU at 48x64: its chained steps against the JAX bench's scan, its
byte-exact gate, its command line and its variant runner."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.models import DeltaStreamPipeline as JaxPipeline
from cudavideostream_tpu.models import variants as jax_variants
from cudavideostream_tpu.runtime import sources as jax_sources
from cudavideostream_tpu.utils import fonts as jax_fonts
from cudavideostream_tpu_torch import bench
from cudavideostream_tpu_torch.config import StreamConfig
from cudavideostream_tpu_torch.models import DeltaStreamPipeline
from cudavideostream_tpu_torch.models import variants
from cudavideostream_tpu_torch.runtime.sources import device_synthetic_frames

REPO = Path(__file__).resolve().parents[1]
T = 4
TIMEOUT = 120
H, W = bench.CPU_HEIGHT, bench.CPU_WIDTH
JSON_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _jax_scan(jcfg, frames, noise_bank):
    """The JAX bench's chained steps (``bench.py:_bench_config``, its
    ``scan_step`` and ``run_scan``) from ``PRNGKey(7)``: returns the
    generator's ``init``, each step's key words, ``pos`` and digest, and
    the final state."""
    pipe = JaxPipeline(jcfg)
    init, next_frame = jax_sources.device_synthetic_frames(
        jcfg, seed=0, noise_bank=noise_bank)
    ids = jnp.asarray(jax_fonts.encode_text(bench.TEXT, 28), jnp.int32)
    n_chars = jnp.int32(len(bench.TEXT))
    tiled, maskonly = jcfg.tiled_payload, jcfg.maskonly_payload
    has_aux = jcfg.visualizer.value != 0

    def scan_step(carry, t):
        prev, key = carry
        key, sub = jax.random.split(key)
        out = pipe._step_impl(prev, next_frame(sub, t), ids, n_chars)
        if maskonly:
            pos, _counts, vals, xs = out[1:5]
        elif tiled:
            pos, _counts, xs, vals = out[1:5]
        else:
            pos, xs, vals = out[1:4]
        digest = jnp.sum(xs) + jnp.sum(vals.astype(jnp.int32))
        if has_aux:
            digest = digest + jnp.sum(out[-1].astype(jnp.int32))
        return (out[0], key), (pos, digest, jax.random.key_data(sub))

    @jax.jit
    def run_scan(prev, key):
        return jax.lax.scan(scan_step, (prev, key), jnp.arange(frames))

    (prev, _), (pos, digests, words) = run_scan(
        jnp.asarray(np.asarray(init)), jax.random.PRNGKey(bench.KEY_SEED))
    return (np.asarray(init), np.asarray(words), np.asarray(pos),
            np.asarray(digests), np.asarray(prev))


def _configs(name, **kw):
    """The port's and the JAX package's configuration of a case: the
    headline's (``tiled`` or ``flat``) or a named variant's, at 48x64."""
    if name in ("tiled", "flat"):
        p = StreamConfig(tiled_payload=name == "tiled")
        j = JaxConfig(tiled_payload=name == "tiled")
    else:
        p, j = variants.get_config(name), jax_variants.get_config(name)
    size = dict(height=H, width=W, **kw)
    return dataclasses.replace(p, **size), dataclasses.replace(j, **size)


@pytest.mark.parametrize("name,kw,noise_bank", [
    ("tiled", {}, 8),
    ("tiled", {"overlay_scale": 4}, 8),
    ("tiled", {"subtile_rows": 8}, 8),
    ("flat", {}, 8),
    ("flat", {"overlay_scale": 4}, 0),
    ("delta-maskonly", {}, 8),
    ("binarize", {}, 8),
    ("tiled", {"overlay_scale": 4}, 0),
])
def test_chain_matches_the_jax_scan(name, kw, noise_bank):
    """T chained steps of the port (the JAX ``init`` as the generator's
    background, the JAX step keys' words in ``keys``): the JAX scan's
    per-step ``pos``, digests mod 2**32 and final state."""
    cfg, jcfg = _configs(name, **kw)
    init, words, pos, digests, prev = _jax_scan(jcfg, T, noise_bank)
    chain = bench.BenchChain(cfg, bench.TEXT, T, noise_bank, device="cpu",
                             background=init)
    chain.keys.copy_(torch.from_numpy(words.astype(np.int64)))
    carry = chain.init.clone()
    for t in range(T):
        carry = chain.step(carry, t)
    np.testing.assert_array_equal(chain.pos.numpy(), pos)
    # both wrap in int32: equal as they are, so equal mod 2**32
    assert chain.digests.dtype == torch.int32
    np.testing.assert_array_equal(chain.digests.numpy(),
                                  digests.astype(np.int32))
    np.testing.assert_array_equal(carry.numpy(), prev)
    np.testing.assert_array_equal(chain.init.numpy(), init)  # not written
    assert chain.pos.sum() > 0


@pytest.mark.parametrize("name", variants.available())
def test_gate_passes_for_every_variant(name, capsys):
    cfg = dataclasses.replace(variants.get_config(name), height=H, width=W)
    res = bench.run_config(cfg, bench.TEXT, frames=2, iters=1, label=name,
                           device="cpu")
    assert res["fps"] is None and res["device"] == "cpu"
    assert res["gate_pos"] > 0 and len(res["pos"]) == 2
    assert f"[{name}] byte-exact vs oracle: OK" in capsys.readouterr().err


def _flip_first_shipped_byte(cfg, out):
    """Flip one bit of the first shipped value of a step's payload."""
    _, pos, xs, vals, _ = bench.payload_parts(cfg, out)
    if cfg.tiled_payload:
        u = int(torch.nonzero(out[2])[0])
        vals[u, 0] ^= 1
    else:
        vals[0] ^= 1


@pytest.mark.parametrize("name", ["tiled", "flat", "delta-maskonly"])
def test_gate_raises_on_one_flipped_payload_byte(name, monkeypatch):
    cfg, _ = _configs(name)
    real = DeltaStreamPipeline.step

    def step(self, prev, frame, text=""):
        out = real(self, prev, frame, text=text)
        _flip_first_shipped_byte(cfg, out)
        return out

    monkeypatch.setattr(DeltaStreamPipeline, "step", step)
    chain = bench.BenchChain(cfg, bench.TEXT, 2, device="cpu")
    with pytest.raises(AssertionError, match="vals"):
        bench.gate(chain, name)


def test_gate_raises_on_a_wrong_state(monkeypatch):
    cfg, _ = _configs("tiled")
    real = DeltaStreamPipeline.step

    def step(self, prev, frame, text=""):
        out = real(self, prev, frame, text=text)
        out[0][5] ^= 0x80
        return out

    monkeypatch.setattr(DeltaStreamPipeline, "step", step)
    with pytest.raises(AssertionError, match="new_prev"):
        bench.run_config(cfg, bench.TEXT, 2, 1, device="cpu")
    # --skip-check skips the gate, as in the JAX bench
    res = bench.run_config(cfg, bench.TEXT, 2, 1, skip_check=True,
                           device="cpu")
    assert res["gate_pos"] is None


@pytest.mark.parametrize("emit", ["tiled", "flat"])
def test_main_prints_one_json_line(emit, capsys):
    rc = bench.main(["--device", "cpu", "--frames", "2", "--iters", "1",
                     "--emit", emit])
    out, err = capsys.readouterr()
    assert rc == 0
    lines = out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == JSON_KEYS
    assert rec["metric"] == "1080p_fps_per_chip_diff_encode_compact"
    assert rec["unit"] == "fps"
    # no device metric from a CPU run
    assert rec["value"] is None and rec["vs_baseline"] is None
    assert f"{H}x{W} on cpu (emit={emit})" in err
    assert "[headline] byte-exact vs oracle: OK" in err


def test_main_subtile_and_noise_bank_zero(capsys):
    assert bench.main(["--device", "cpu", "--frames", "3", "--iters", "2",
                       "--subtile", "8", "--noise-bank", "0"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 1


def test_full_is_a_usage_error_naming_the_roadmap_item(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["--full", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md M9" in err and "benchmarks/kernels.py" in err


def test_main_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                       capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.main(["--frames", "2", "--iters", "1"])
    assert capsys.readouterr().out == ""


def test_noise_bank_zero_tensor_seed_equals_the_int_path():
    """``--noise-bank 0``: the key words as a tensor (read on the device,
    as a CUDA graph reads its static key tensor) give the int path's
    frames, over words with the high bit set and t across the box's
    travel."""
    cfg = StreamConfig(height=H, width=W)
    _, next_frame = device_synthetic_frames(cfg, seed=5, noise_bank=0,
                                            device="cpu")
    words = np.random.default_rng(9).integers(0, 2**32, (12, 2),
                                              dtype=np.uint64)
    words[0] = (2**32 - 1, 2**31)
    for t, w in enumerate(words):
        want = next_frame([int(w[0]), int(w[1])], 3 * t)
        got = next_frame(torch.tensor(w.astype(np.int64)), 3 * t)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the chain draws new words on each refill from its generator
    chain = bench.BenchChain(cfg, bench.TEXT, 3, noise_bank=0, device="cpu")
    gen = torch.Generator().manual_seed(bench.KEY_SEED)
    chain.refill_keys(gen)
    first = chain.keys.clone()
    chain.refill_keys(gen)
    assert not torch.equal(first, chain.keys)
    assert (chain.keys >= 0).all() and (chain.keys < 2**32).all()
    f0 = chain.frame(0)
    np.testing.assert_array_equal(
        f0.numpy(), chain.next_frame(chain.keys[0].tolist(), 0).numpy())


def test_noise_bank_ignores_the_keys():
    cfg = StreamConfig(height=H, width=W)
    chain = bench.BenchChain(cfg, bench.TEXT, 2, noise_bank=8, device="cpu")
    chain.refill_keys(torch.Generator().manual_seed(1))
    assert not chain.keys.any()  # nothing drawn under a bank
    a = chain.frame(1)
    chain.keys.fill_(12345)
    np.testing.assert_array_equal(a.numpy(), chain.frame(1).numpy())


class _Proc:
    def __init__(self, rc, out, err=""):
        self.returncode, self.stdout, self.stderr = rc, out, err


def test_all_variants_runs_one_child_each(monkeypatch, tmp_path, capsys):
    cmds = []

    def run(cmd, **kw):
        assert kw["timeout"] == bench.VARIANT_TIMEOUT_S
        assert kw["cwd"] == bench.REPO
        cmds.append(cmd)
        name = cmd[cmd.index("--one-variant") + 1]
        return _Proc(0, "noise\n" + json.dumps(
            {"metric": f"variant_fps:{name}", "value": 100.0 + len(cmds),
             "unit": "fps", "vs_baseline": 4.0}) + "\n")

    out_json = tmp_path / "bench" / "variants.json"
    monkeypatch.setattr(bench.subprocess, "run", run)
    monkeypatch.setattr(bench, "VARIANTS_JSON", out_json)
    args = bench._parser().parse_args(["--frames", "8", "--iters", "3",
                                       "--emit", "flat", "--device", "cpu"])
    assert bench._all_variants(args) == []
    assert [c[c.index("--one-variant") + 1] for c in cmds] == \
        variants.available()
    assert cmds[0][:3] == [sys.executable, "-m",
                           "cudavideostream_tpu_torch.bench"]
    for flag, value in (("--emit", "flat"), ("--frames", "8"),
                        ("--iters", "3"), ("--noise-bank", "8"),
                        ("--device", "cpu")):
        assert cmds[0][cmds[0].index(flag) + 1] == value
    table = json.loads(out_json.read_text())
    assert list(table) == variants.available()
    assert table["binarize"] == 101.0
    assert "wrote" in capsys.readouterr().err


def test_all_variants_fails_on_a_failing_child(monkeypatch, tmp_path,
                                               capsys):
    def run(cmd, **kw):
        name = cmd[cmd.index("--one-variant") + 1]
        if name == "heatmap":
            return _Proc(1, "", "AssertionError: [heatmap] vals: 1 entries")
        if name == "grayscale":
            return _Proc(0, "not json\n")  # no line of its own: a failure
        return _Proc(0, json.dumps({"metric": f"variant_fps:{name}",
                                    "value": 50.0}))

    out_json = tmp_path / "variants.json"
    monkeypatch.setattr(bench.subprocess, "run", run)
    monkeypatch.setattr(bench, "VARIANTS_JSON", out_json)
    monkeypatch.setattr(bench, "run_config", lambda *a, **k: {
        "fps": 10.0, "device": "stub"})
    rc = bench.main(["--all-variants", "--device", "cpu", "--frames", "2",
                     "--iters", "1"])
    out, err = capsys.readouterr()
    assert rc == 1
    assert len(out.splitlines()) == 1
    assert json.loads(out)["value"] == 10.0
    assert "[heatmap] FAILED (rc=1)" in err and "[grayscale] FAILED" in err
    assert not out_json.exists()


def test_all_variants_fails_on_a_child_that_hangs(monkeypatch, tmp_path):
    def run(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(bench.subprocess, "run", run)
    monkeypatch.setattr(bench, "VARIANTS_JSON", tmp_path / "v.json")
    args = bench._parser().parse_args(["--device", "cpu"])
    assert bench._all_variants(args) == variants.available()


def test_one_variant_child_process():
    """The hidden ``--one-variant`` child, as the parent starts it: one
    stdout line, ``variant_fps:<name>``."""
    proc = subprocess.run(
        [sys.executable, "-m", "cudavideostream_tpu_torch.bench",
         "--one-variant", "delta-maskonly", "--device", "cpu", "--frames",
         "2", "--iters", "1"], capture_output=True, text=True, cwd=REPO,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "variant_fps:delta-maskonly"
    assert set(rec) == JSON_KEYS and rec["value"] is None
    assert "[delta-maskonly] byte-exact vs oracle: OK" in proc.stderr


def test_step_digest_reads_the_aux_frame():
    cfg = dataclasses.replace(variants.get_config("grayscale"), height=H,
                              width=W)
    chain = bench.BenchChain(cfg, bench.TEXT, 1, device="cpu")
    out = chain.pipe.step(chain.init.clone(), chain.frame(0), bench.TEXT)
    _, _, xs, vals, aux = bench.payload_parts(cfg, out)
    assert int(bench.step_digest(cfg, out)) == (
        int(xs.sum()) + int(vals.to(torch.int64).sum())
        + int(aux.to(torch.int64).sum()))


def test_step_digest_wraps_in_int32_as_jax():
    """A payload whose sum passes 2**31: the port's digest is the JAX
    digest's int32 wrap, bit for bit."""
    cfg = dataclasses.replace(StreamConfig(), height=H, width=W)
    rng = np.random.default_rng(3)
    xs = rng.integers(1 << 29, (1 << 31) - 1, 64, dtype=np.int32)
    vals = rng.integers(0, 256, 64, dtype=np.uint8)
    out = (None, torch.tensor(64, dtype=torch.int32), torch.from_numpy(xs),
           torch.from_numpy(vals), None)
    want = jnp.sum(jnp.asarray(xs)) + jnp.sum(jnp.asarray(vals, jnp.int32))
    got = bench.step_digest(cfg, out)
    assert got.dtype == torch.int32
    assert int(got) == int(want)
    assert int(xs.astype(np.int64).sum()) >= 1 << 31  # it did wrap
