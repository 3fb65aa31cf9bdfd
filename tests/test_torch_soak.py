"""Adversarial serving soak of the port — the JAX package's
``tests/test_soak.py`` against ``cudavideostream_tpu_torch``: the
composed state machine under fuzz, as a session runs it. Overlay text
churn x the depth-K landing queue x the v4 adaptive encoder (delta16 /
bitmask / raw / winmask, chosen per frame) x scene cuts x density swings
x empty frames x client reconnects: 400 frames, every landed payload
encoded to real wire bytes, decoded by the port's and the JAX package's
``unpack_frame_v3`` alike, and held byte-exact against the JAX package's
``step_oracle``.

The JAX test also asserts that its lander's speculative windows both hit
and missed; the port has no speculative windows (by design), so that
assertion has no counterpart here.
"""

import numpy as np
import pytest

from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.ops import reference_cpu as jax_ref
from cudavideostream_tpu.runtime import wire as jax_wire
from cudavideostream_tpu.utils import fonts as jax_fonts
from cudavideostream_tpu_torch.config import StreamConfig
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.executor import BatchedLandExecutor

N_FRAMES = 400          # per scenario; a few minutes of 30 fps serving
DEPTH = 5


def _random_walk_frames(rng, base, n):
    """Adversarial frame script: a drifting band whose width, velocity,
    and delta churn randomly, plus scene cuts, dense bursts, and exact
    repeats (pos == 0 frames). The JAX test's script, draw for draw."""
    size = base.size
    frame = base.copy()
    start, width, vel = 5000, 4000, 512
    for _ in range(n):
        r = rng.random()
        if r < 0.03:                      # scene cut: everything changes
            if rng.random() < 0.5:
                # +128: every byte crosses the threshold (pos == n), the
                # only density where the v4 raw mode is cheapest
                frame = frame + np.uint8(128)
            else:
                frame = rng.integers(0, 255, size, endpoint=True,
                                     dtype=np.uint8)
            yield frame.copy()
            continue
        if r < 0.08:                      # exact repeat: pos == 0
            yield frame.copy()
            continue
        if r < 0.13:                      # dense burst: ~40% of frame
            f = frame.copy()
            m = rng.random(size) < 0.4
            f[m] += rng.integers(30, 200, int(m.sum())).astype(np.uint8)
            frame = f
            yield frame.copy()
            continue
        if rng.random() < 0.1:            # velocity jump
            vel = int(rng.integers(-4096, 4096))
        width = int(np.clip(width + rng.integers(-1500, 1500), 500, 20000))
        start = int((start + vel) % max(1, size - width))
        f = frame.copy()
        f[start:start + width] += np.uint8(rng.integers(25, 200))
        frame = f
        yield frame.copy()


@pytest.mark.parametrize("maskonly", [False, True],
                         ids=["indexed", "maskonly"])
def test_v4_serving_soak(maskonly):
    fields = dict(height=96, width=128, overlay_scale=4, tiled_payload=True,
                  fetch_mode="mask", emit_bitmask=True, mask_payload=True,
                  wire_format="v4", maskonly_payload=maskonly)
    cfg, jcfg = StreamConfig(**fields), JaxConfig(**fields)
    rng = np.random.default_rng(20260820 + maskonly)
    n = cfg.frame_bytes
    base = rng.integers(0, 255, n, endpoint=True, dtype=np.uint8)

    ex = BatchedLandExecutor(cfg, depth=DEPTH, device="cpu")
    ex.start(base)
    atlas = jax_fonts.make_atlas(jcfg.overlay_scale, jcfg.overlay_font)
    enc = wire.V4Encoder(base)            # per-connection wire shadow
    recon = base.copy()                   # client reconstruction
    oracle_prev = base.copy()
    expected = []                         # oracle prevs awaiting landing
    modes_seen = set()
    text, next_text_change = "", 0

    def land(results):
        nonlocal recon
        for pos, xs, vals, _aux in results:
            want = expected.pop(0)
            # round-trip through real wire bytes: encode (adaptive mode
            # choice + shadow apply), then decode as a client does
            buf = enc.encode(pos, xs, vals)
            modes_seen.add(buf[0])
            p, dx, dv, raw, used = wire.unpack_frame_v3(buf, 0, n)
            assert used == len(buf)
            jp, jdx, jdv, jraw, jused = jax_wire.unpack_frame_v3(buf, 0, n)
            assert (p, used) == (jp, jused)
            assert (raw is None) == (jraw is None)
            if raw is not None:
                np.testing.assert_array_equal(raw, jraw)
                recon = raw.copy()
            elif p:
                np.testing.assert_array_equal(dx, jdx)
                np.testing.assert_array_equal(dv, jdv)
                w = recon.astype(np.int32)
                np.add.at(w, dx, dv.astype(np.int32))
                recon = (w % 256).astype(np.uint8)
            np.testing.assert_array_equal(recon, want)

    for t, frame in enumerate(_random_walk_frames(rng, base, N_FRAMES)):
        if t >= next_text_change:         # text churn; empty-text
            # stretches (overlay off) let a +128 scene cut change every
            # byte, the only way the v4 raw mode can win
            text = "" if rng.random() < 0.25 else f"FPS {t} BW {t * 7}"
            next_text_change = t + int(rng.integers(5, 20))
        ids = jax_fonts.encode_text(text)
        oracle_prev, _, _, _, _ = jax_ref.step_oracle(
            oracle_prev, frame, jcfg, atlas=atlas, char_ids=ids)
        expected.append(oracle_prev.copy())
        out = ex.process(frame, text=text)
        if out is not None:
            land(out)
        if t > 0 and t % 150 == 0:        # client reconnect mid-session
            tail = ex.flush()
            if tail:
                land(tail)
            snap = ex.resync()
            assert not expected
            # a fresh client bootstraps from the resync frame, which must
            # be the oracle's state
            np.testing.assert_array_equal(snap, oracle_prev)
            enc = wire.V4Encoder(snap.copy())
            recon = snap.copy()

    tail = ex.flush()
    if tail:
        land(tail)
    assert not expected
    np.testing.assert_array_equal(ex.resync(), oracle_prev)
    # the encoder exercised at least 3 of its 4 modes
    assert len(modes_seen) >= 3, modes_seen
