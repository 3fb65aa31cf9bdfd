"""Render the visual artifacts (the port of the JAX package's
``examples/make_artifacts.py``, through the port's copies of
``reference_cpu``, ``wire``, ``fonts`` and ``png``; the same bytes).

The reference's third verification leg is *looking at the video*
(``client/opencv.cpp:68-69`` imshow; server aux display thread
``threads.cpp:149-164``). This writes rendered evidence into ``--out``:

* ``<visualizer>_aux.png`` — each visualizer's aux frame at 1080p;
* ``scene.png`` — the input frame for comparison;
* ``session.cvs.gz`` and ``session_final.png`` — a gzipped wire-format
  session (base + payloads, what ``client --record`` captures) playable
  in ``examples/viewer.html``, and its last reconstruction;
* ``session_v3.cvs.gz`` — the same scene over the v3 adaptive wire.

Frames are rendered through the byte-exact NumPy spec
(``ops/reference_cpu``), which the tests and ``chip_smoke.py`` hold the
card's pipeline to, so no card is needed. A smooth procedural scene is
used (gradients compress; white noise would make multi-MB PNGs).

    python -m cudavideostream_tpu_torch.examples.make_artifacts \
        [--out build/examples/artifacts]
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import os
import sys
from pathlib import Path

import numpy as np

from cudavideostream_tpu_torch.config import StreamConfig, Visualizer
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.utils import fonts
from cudavideostream_tpu_torch.utils.png import bgr_frame_to_rgb, write_png

DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build" / "examples"
               / "artifacts")


def demo_scene(cfg: StreamConfig, t: int, rng, noise: int = 0) -> np.ndarray:
    """Smooth gradient background + two moving objects (+ optional sensor
    noise). Noise defaults to 0: high-entropy noise defeats DEFLATE and
    the PNGs and sessions must stay small."""
    h, w = cfg.height, cfg.width
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    img = np.empty((h, w, 3), np.int32)
    img[:, :, 0] = 40 + 160 * y // max(1, h)          # B ramps down
    img[:, :, 1] = 30 + 180 * x // max(1, w)          # G ramps right
    img[:, :, 2] = 120 + 90 * ((x + y) % 256) // 256  # R diagonal bands
    if noise:
        img += rng.integers(-noise, noise, img.shape, endpoint=True)
    s = h // 6
    yy = (40 + t * 14) % (h - s)
    xx = (60 + t * 31) % (w - s)
    img[yy : yy + s, xx : xx + s] = (250, 250, 250)
    y2 = (h // 2 + t * 9) % (h - s // 2)
    x2 = (w // 3 + t * 17) % (w - s // 2)
    img[y2 : y2 + s // 2, x2 : x2 + s // 2] = (30, 30, 200)  # red box (BGR)
    return np.clip(img, 0, 255).astype(np.uint8).ravel()


def render_visualizers(out: str, n_frames: int = 6) -> None:
    cfg1080 = StreamConfig()
    for viz in (
        Visualizer.HEATMAP,
        Visualizer.RED_BLACK,
        Visualizer.RED_OVERLAP,
        Visualizer.GRAYSCALE,
        Visualizer.BINARIZE,
    ):
        cfg = dataclasses.replace(cfg1080, visualizer=viz)
        rng_v = np.random.default_rng(11)
        prev = demo_scene(cfg, 0, rng_v)
        aux = None
        for t in range(1, n_frames):
            cur = demo_scene(cfg, t, rng_v)
            prev, pos, xs, vals, aux = ref.step_oracle(
                prev, cur, cfg, atlas=None, char_ids=[]
            )
        name = viz.name.lower()
        write_png(
            os.path.join(out, f"{name}_aux.png"),
            bgr_frame_to_rgb(aux, cfg.height, cfg.width),
        )
        print(f"wrote {name}_aux.png")
    scene = demo_scene(cfg1080, n_frames - 1, np.random.default_rng(11))
    write_png(
        os.path.join(out, "scene.png"),
        bgr_frame_to_rgb(scene, cfg1080.height, cfg1080.width),
    )
    print("wrote scene.png")


def _write_gz(path: str, raw: bytes) -> None:
    with open(path, "wb") as raw_f, gzip.GzipFile(
        fileobj=raw_f, mode="wb", compresslevel=9, mtime=0
    ) as f:  # mtime=0: reproducible bytes
        f.write(raw)


def record_session(out: str, n_frames: int = 36) -> None:
    """A wire-format session (base + payloads + status overlay) small
    enough to keep; examples/viewer.html replays it in a browser."""
    cfg = StreamConfig(height=270, width=480, overlay_scale=2)
    rng = np.random.default_rng(5)
    atlas = fonts.make_atlas(cfg.overlay_scale)
    base = demo_scene(cfg, 0, rng)
    chunks = [base.tobytes()]
    prev = base.copy()
    client = base.copy()
    for t in range(1, n_frames + 1):
        cur = demo_scene(cfg, t, rng)
        ids = fonts.encode_text(f"FPS: {60 + t}")
        prev, pos, xs, vals, _ = ref.step_oracle(
            prev, cur, cfg, atlas=atlas, char_ids=ids
        )
        chunks.append(wire.pack_payload(pos, xs, vals))
        client = ref.client_apply(client, xs, vals)
    if not np.array_equal(client, prev):  # session self-check
        raise AssertionError("the session's client state is not the spec's")
    raw = b"".join(chunks)
    path = os.path.join(out, "session.cvs.gz")
    _write_gz(path, raw)
    write_png(
        os.path.join(out, "session_final.png"),
        bgr_frame_to_rgb(client, cfg.height, cfg.width),
    )
    print(
        f"wrote session.cvs.gz ({len(raw)} wire bytes, "
        f"{os.path.getsize(path)} gz) + session_final.png"
    )


def record_session_v3(out: str, n_frames: int = 36) -> None:
    """The same scene over the v3 adaptive wire, with a mid-stream scene
    inversion (~85% density -> bitmask mode; even full inversion stays
    under raw's ~87.5% crossover because bytes in [118..137] move by <=
    20) and a lighting flip (+130 on every byte -> 100% -> raw)."""
    cfg = StreamConfig(height=270, width=480, overlay_scale=2)
    rng = np.random.default_rng(5)
    atlas = fonts.make_atlas(cfg.overlay_scale)
    base = demo_scene(cfg, 0, rng)
    chunks = [wire.MAGIC_V3, base.tobytes()]
    prev = base.copy()
    enc = wire.V3Encoder(base)
    modes = []
    for t in range(1, n_frames + 1):
        cur = demo_scene(cfg, t, rng)
        if t == n_frames // 3:
            cur = 255 - cur  # scene inversion: ~85% -> bitmask
        elif t == 2 * n_frames // 3:
            # lighting flip: every byte moves by 130 (mod 256) -> raw
            cur = ((cur.astype(np.int16) + 130) % 256).astype(np.uint8)
        ids = fonts.encode_text(f"FPS: {60 + t}")
        prev, pos, xs, vals, _ = ref.step_oracle(
            prev, cur, cfg, atlas=atlas, char_ids=ids
        )
        chunks.append(enc.encode(pos, xs, vals))
        modes.append(enc.last_mode)
    if not np.array_equal(enc.frame, prev):  # session self-check
        raise AssertionError("the v3 session's state is not the spec's")
    if set(modes) != {wire.MODE_DELTA16, wire.MODE_BITMASK, wire.MODE_RAW}:
        raise AssertionError(f"the v3 session missed a mode: {modes}")
    raw = b"".join(chunks)
    path = os.path.join(out, "session_v3.cvs.gz")
    _write_gz(path, raw)
    print(
        f"wrote session_v3.cvs.gz ({len(raw)} wire bytes, "
        f"{os.path.getsize(path)} gz; modes {modes})"
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=str(DEFAULT_OUT))
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    render_visualizers(args.out)
    record_session(args.out)
    record_session_v3(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
