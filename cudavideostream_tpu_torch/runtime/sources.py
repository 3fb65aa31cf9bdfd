"""Frame sources: where frames come from (port of the JAX package's
``runtime/sources.py``).

The reference captures via OpenCV/V4L2 on a dedicated pthread feeding a
pipe-based ring (``threads.cpp:166-179``); capture dominates its wall
clock (~30-40 ms/frame, report.tex:782). Here a source is a simple
iterator protocol the executor pulls from.

Sources:

* :class:`SyntheticSource` — procedural scene (sensor noise + moving
  bright square), NumPy with the JAX package's seed semantics, so both
  packages see identical frames.
* :class:`FileSource` — a ``.npy`` stack or raw BGR24 file, the analogue
  of the reference's file-based socket tests
  (``tests/test_socket_opencv_webcam/image_reader.cpp:63``).
* :class:`V4L2Source` — a real camera through the port's native library
  (``native/csrc/cvstpu.c``: ioctl and mmap, like
  ``tests/cuda_streaming/v4l.cpp``), raw BGR24 or MJPG decoded by
  :func:`decode_mjpg_frame`.
* :class:`PrefetchSource` — any source captured ahead on its own thread,
  the reference's capture pthread.
* :func:`device_synthetic_frames` — frames generated on the device, in
  torch ops, bit-exact with the JAX package's generator given its
  background.
"""

from __future__ import annotations

import ctypes
import io
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from cudavideostream_tpu_torch import native
from cudavideostream_tpu_torch.config import StreamConfig
from cudavideostream_tpu_torch.models.pipeline import resolve_device

# the native library's v4l2_open code for a device that offers neither
# raw BGR24 nor MJPG at the asked geometry
V4L2_ERR_FORMAT = -2000


class FrameSource:
    """Iterator protocol: ``__next__`` returns a flat uint8 frame."""

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:  # pragma: no cover - interface
        raise NotImplementedError

    def base_frame(self) -> np.ndarray:
        """First frame, used for the base-frame handshake."""
        return next(self)


class SyntheticSource(FrameSource):
    """Procedural scene: static textured background + per-frame sensor
    noise below the diff threshold + a moving bright rectangle above it.

    Calibrated so the changed-byte rate is in the ballpark of the
    reference's measured 5.93% (report.tex:2594).
    """

    def __init__(self, config: StreamConfig, seed: int = 0, noise: int = 10,
                 object_size: int = 200, speed: int = 12):
        self.cfg = config
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.object_size = object_size
        self.speed = speed
        self.t = 0
        self.background = self.rng.integers(
            0, 255, config.frame_bytes, endpoint=True, dtype=np.uint8
        )

    def __next__(self) -> np.ndarray:
        cfg = self.cfg
        img = self.background.reshape(cfg.height, cfg.width, 3).astype(np.int16)
        if self.noise:
            img = img + self.rng.integers(
                -self.noise, self.noise, img.shape, endpoint=True,
                dtype=np.int16
            )
        s = max(1, min(self.object_size, cfg.height // 2, cfg.width // 2))
        y = (self.t * self.speed) % max(1, cfg.height - s)
        x = (self.t * self.speed * 2) % max(1, cfg.width - s)
        img[y : y + s, x : x + s] = 255
        self.t += 1
        return np.clip(img, 0, 255).astype(np.uint8).ravel()


class FileSource(FrameSource):
    """Frames from a ``.npy`` array of shape (n, H*W*3) or (n, H, W, 3),
    or a raw concatenated-BGR24 file; loops when exhausted."""

    def __init__(self, path: str, config: StreamConfig, loop: bool = True):
        self.cfg = config
        self.loop = loop
        if path.endswith(".npy"):
            arr = np.load(path)
            self.frames = arr.reshape(arr.shape[0], -1).astype(np.uint8)
        else:
            raw = np.fromfile(path, dtype=np.uint8)
            n = raw.size // config.frame_bytes
            if n == 0:
                raise ValueError(f"{path}: smaller than one frame")
            self.frames = raw[: n * config.frame_bytes].reshape(n, -1)
        if self.frames.shape[1] != config.frame_bytes:
            raise ValueError(
                f"{path}: frame size {self.frames.shape[1]} != "
                f"{config.frame_bytes}"
            )
        self.i = 0

    def __next__(self) -> np.ndarray:
        if self.i >= len(self.frames):
            if not self.loop:
                raise StopIteration
            self.i = 0
        f = self.frames[self.i]
        self.i += 1
        return f


def decode_mjpg_frame(data: bytes, height: int, width: int) -> np.ndarray:
    """Decode one MJPG (JPEG) camera frame to flat BGR24 bytes.

    The reference captures 1080p as MJPG because raw BGR24 at 1080p30
    exceeds USB2 bandwidth (``threads.cpp:34-38``) and lets OpenCV
    decode; here Pillow decodes. Raises ``RuntimeError`` on a geometry
    mismatch or an undecodable frame.
    """
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - Pillow is installed
        raise RuntimeError(
            "MJPG camera stream needs Pillow to decode; install PIL or "
            "use a BGR24-capable device"
        ) from e
    try:
        img = Image.open(io.BytesIO(data))
        rgb = np.asarray(img.convert("RGB"), dtype=np.uint8)
    except Exception as e:  # Pillow raises many types on corrupt data
        raise RuntimeError(f"MJPG frame decode failed: {e}") from e
    if rgb.shape[:2] != (height, width):
        raise RuntimeError(
            f"MJPG frame is {rgb.shape[1]}x{rgb.shape[0]}, "
            f"expected {width}x{height}"
        )
    return rgb[..., ::-1].reshape(-1).copy()  # RGB -> BGR, flat


class V4L2Source(FrameSource):
    """Camera capture through the port's native library.

    The library negotiates the pixel format: raw BGR24 preferred, MJPEG
    accepted (decoded on the host by :func:`decode_mjpg_frame` — real
    1080p30 USB cameras only do MJPG, like the reference's,
    ``threads.cpp:34-38``). Any other format is a hard error, never
    silently-garbage frames. Raises ``RuntimeError`` when the device is
    absent or cannot be opened.
    """

    def __init__(self, config: StreamConfig, device: str = "/dev/video0"):
        self.cfg = config
        if not os.path.exists(device):
            raise RuntimeError(f"camera device {device} not present")
        lib = native.load()
        rc = lib.v4l2_open(device.encode(), config.width, config.height)
        if rc == V4L2_ERR_FORMAT:
            raise RuntimeError(
                f"{device} offers neither BGR24 nor MJPG at "
                f"{config.width}x{config.height}"
            )
        if rc < 0:
            raise RuntimeError(f"v4l2_open({device}) failed: {rc}")
        # held from here on: close() and __del__ release the camera
        self._lib = lib
        self._mjpg = rc == 1
        self._handle = 0
        self._buf = np.empty(config.frame_bytes, dtype=np.uint8)

    def __next__(self) -> np.ndarray:
        n = self._lib.v4l2_grab(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._buf.size,
        )
        if n < 0:
            raise RuntimeError(f"v4l2_grab failed: {n}")
        if self._mjpg:
            return decode_mjpg_frame(
                self._buf[:n].tobytes(), self.cfg.height, self.cfg.width
            )
        if n != self.cfg.frame_bytes:
            raise RuntimeError(
                f"short BGR24 frame: {n} of {self.cfg.frame_bytes} bytes"
            )
        return self._buf.copy()

    def close(self) -> None:
        """Idempotent; must run before another V4L2Source can open (the
        native library holds one process-wide camera handle)."""
        lib, self._lib = getattr(self, "_lib", None), None
        if lib is not None:
            lib.v4l2_close(self._handle)

    # the camera handle is process-global: a dropped or failed source must
    # not claim it forever (a decode error mid-stream abandons the object;
    # the next V4L2Source would fail until the process restarts)
    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: nothing left to report to
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PrefetchSource(FrameSource):
    """Capture-prefetch thread — the reference's dedicated capture
    pthread (``th_cap_hdl``, ``threads.cpp:166-179``), which overlaps the
    ~30-40 ms V4L2/MJPG grab with compute and send.

    Wraps any source: a daemon thread pulls ``next(inner)`` into a
    bounded queue; the serving loop pops ready frames. The queue depth
    bounds staleness: depth 1 (the default) captures at most one frame
    ahead, the reference's one-in-flight ring handoff. A source exception
    (a camera dying mid-stream) is raised again in the consumer;
    :meth:`close` stops the thread, joins it with a timeout and closes the
    inner source.
    """

    _DONE = object()
    JOIN_TIMEOUT_S = 2.0

    def __init__(self, inner: FrameSource, depth: int = 1):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.inner = inner
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def base_frame(self) -> np.ndarray:
        # the handshake stays synchronous (the thread starts on the first
        # __next__)
        return self.inner.base_frame()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self._put(next(self.inner))
        except StopIteration:
            self._put(self._DONE)
        except BaseException as e:  # the consumer raises it again
            self._exc = e
            self._put(self._DONE)

    def __next__(self) -> np.ndarray:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="cvstpu-prefetch", daemon=True
            )
            self._thread.start()
        item = self._q.get()
        if item is self._DONE:
            # later calls end the same way
            self._q.put(self._DONE)
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.JOIN_TIMEOUT_S)
            self._thread = None
        inner_close = getattr(self.inner, "close", None)
        if inner_close is not None:
            inner_close()


def make_source(kind: str, config: StreamConfig, path: Optional[str] = None,
                seed: int = 0) -> FrameSource:
    if kind == "synthetic":
        return SyntheticSource(config, seed=seed)
    if kind == "file":
        if not path:
            raise ValueError("file source needs --path")
        return FileSource(path, config)
    if kind == "v4l2":
        return V4L2Source(config, device=path or "/dev/video0")
    raise ValueError(f"unknown source kind {kind!r}")


# -- the device generator -----------------------------------------------------

_M32 = 0xFFFFFFFF
# the counter hash's odd multipliers (the JAX package's _hash_noise)
_H0, _H1, _H2 = 2654435761, 0x2C1B3C6D, 0x297A2D39


def device_synthetic_frames(config: StreamConfig, seed: int = 0,
                            noise_bank: int = 0, device=None,
                            background=None):
    """On-device procedural frame generator (the JAX package's
    ``device_synthetic_frames``, in torch ops; XLA there, no kernel).

    Returns ``(init_frame, next_frame)``: ``init_frame`` the flat uint8
    background on ``device`` (the card unless the caller asks for another,
    as every entry point of the port), ``next_frame(key, t)`` the flat
    uint8 frame of step ``t``, made on the device from the background, a
    ±10 noise from a counter hash and the moving 200-pixel box.

    * The background is ``numpy.random.default_rng(seed)`` (PCG64)
      integers in ``[0, 255]``, made on the host and copied up, so it is
      the same on every device; the JAX package draws it with
      ``jax.random``, so pass its ``init`` as ``background`` to get its
      frames bit for bit.
    * ``key``: the words of the JAX step's key (``jax.random.key_data``,
      any sequence of uint32 words): the hash's seed is ``key[0] ^
      (key[-1] * 2654435761)`` mod 2**32, as the JAX generator takes it.
    * ``noise_bank > 0`` makes that many clipped noisy planes at init
      (plane ``k`` hashed with seed ``seed * 0x9E3779B9 + 0x85EB + k`` mod
      2**32; the JAX generator refuses a seed whose sum passes 2**32) and
      picks plane ``t % noise_bank``; ``key`` is then unused.

    The uint32 hash runs in int64, masked to 32 bits after every multiply
    and add; every op works in the ``(h, w*3)`` byte view, as the JAX
    generator does.
    """
    h, w = config.height, config.width
    w3 = w * 3
    if background is None:
        bg = np.random.default_rng(seed).integers(
            0, 255, h * w3, endpoint=True, dtype=np.uint8)
    else:
        bg = np.asarray(background, dtype=np.uint8).ravel()
        if bg.size != h * w3:
            raise ValueError(f"background has {bg.size} bytes, frame has "
                             f"{h * w3}")
    device = resolve_device(device)
    background_t = torch.from_numpy(bg.copy()).to(device).view(h, w3)
    # idx * 2654435761 mod 2**32 for every byte index, the hash's first
    # multiply, which does not depend on the seed
    idx = torch.arange(h * w3, dtype=torch.int64, device=device).view(h, w3)
    idx_mul = (idx * _H0) & _M32
    del idx

    def hash_noise(seed32: int) -> torch.Tensor:
        """±10 per-byte noise (int32) from the counter hash."""
        z = (idx_mul + (seed32 & _M32)) & _M32
        z = ((z ^ (z >> 15)) * _H1) & _M32
        z = ((z ^ (z >> 12)) * _H2) & _M32
        z = z ^ (z >> 15)
        # mod-21 bias is irrelevant for synthetic sensor noise
        return (z % 21).to(torch.int32) - 10

    s = max(1, min(200, h // 2, w // 2))
    rows = torch.arange(h, dtype=torch.int64, device=device)
    pixels = torch.arange(w3, dtype=torch.int64, device=device) // 3

    def box(t: int) -> torch.Tensor:
        y = (t * 12) % (h - s)
        x = (t * 24) % (w - s)
        return (((rows >= y) & (rows < y + s))[:, None]
                & ((pixels >= x) & (pixels < x + s))[None, :])

    bg32 = background_t.to(torch.int32)
    init = background_t.reshape(-1)
    if noise_bank:
        # noisy planes precomputed (clipped uint8): a frame is one plane
        # read and the moving-box select
        bank = torch.stack([
            torch.clamp(bg32 + hash_noise(seed * 0x9E3779B9 + 0x85EB + k),
                        0, 255).to(torch.uint8)
            for k in range(noise_bank)
        ])
        del bg32

        def next_frame(key, t: int) -> torch.Tensor:
            del key  # the bank is the randomness; t selects the plane
            plane = bank[t % noise_bank]
            return torch.where(box(t), 255, plane).reshape(-1)

        return init, next_frame

    def next_frame(key, t: int) -> torch.Tensor:
        words = [int(k) & _M32 for k in np.asarray(key).ravel()]
        seed32 = words[0] ^ ((words[-1] * _H0) & _M32)
        img = torch.where(box(t), 255, bg32 + hash_noise(seed32))
        return torch.clamp(img, 0, 255).to(torch.uint8).reshape(-1)

    return init, next_frame
