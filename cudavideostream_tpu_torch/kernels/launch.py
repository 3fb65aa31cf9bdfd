"""The seam between the ops modules and the libraries of ``csrc/``.

Each ``csrc/<name>.cu`` exports C functions that return 0 or an error
code (``cvs_error_string`` turns a code into text) and constants of its
launch geometry that the ops module's plans assume. An ops module
declares one :class:`Source` a library beside its constants; everything
else a launch needs from the card is here, each in one place:

* :func:`library` builds the library at first use (:func:`build.load`),
  binds every function of the table and ``cvs_error_string``, checks
  each geometry constant, and caches the bound library in ``build``'s
  cache;
* :func:`raise_on` is the one raise on a failed call;
* :func:`device_index`, :func:`sm_count` and :func:`stream_handle` are the
  device facts a launch passes;
* :func:`scratch` is the self-cleaning scratch of the kernels that merge
  their blocks' work through device memory;
* :func:`query` asks a library once per device what the card holds of a
  kernel (its occupancy, its cluster shape).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Hashable, NamedTuple, Sequence, Tuple

import torch

from cudavideostream_tpu_torch.kernels import build

# the C types of the tables: int, long long, a pointer, an int written back
I, LL, P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
OUT = ctypes.POINTER(ctypes.c_int)

# (device, stream, owning kernel) -> the zeroed scratch (:func:`scratch`)
_scratch: dict = {}
# (query, device index, arguments) -> what the card answered
# (:func:`sm_count`, :func:`query`)
_facts: dict = {}


class Source(NamedTuple):
    """The binding table of ``csrc/<name>.cu``: each exported function
    with its argument types (every one returns an ``int``), and each
    geometry export (no arguments) with the value of the ops module's
    constant that it must equal."""

    name: str
    functions: Dict[str, Sequence]
    constants: Dict[str, int] = {}

    def bind(self, lib: ctypes.CDLL) -> None:
        """Declare every function of the table and ``cvs_error_string``
        on ``lib``, and refuse it where a geometry export disagrees."""
        lib.cvs_error_string.argtypes = [I]
        lib.cvs_error_string.restype = ctypes.c_char_p
        for fn, args in [*self.functions.items(),
                         *((fn, ()) for fn in self.constants)]:
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = I
        for fn, want in self.constants.items():
            got = getattr(lib, fn)()
            if got != want:
                raise RuntimeError(f"csrc/{self.name}.cu disagrees with its "
                                   f"ops module: {fn}() is {got}, the "
                                   f"constant is {want}")


def library(src: Source) -> ctypes.CDLL:
    """The library of ``src``, built, bound and checked at first use."""
    return build.load(src)


def raise_on(rc: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise ``RuntimeError`` on a nonzero return code of ``lib``'s call
    ``what``, with the library's text for it."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.cvs_error_string(rc).decode()} ({rc})")


def device_index(device) -> int:
    """The index of a CUDA device (the current one where it has none)."""
    dev = torch.device(device)
    return dev.index if dev.index is not None else torch.cuda.current_device()


def sm_count(idx: int) -> int:
    """The SMs of device ``idx``, read once per device."""
    key = ("sms", idx)
    if key not in _facts:
        _facts[key] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _facts[key]


def stream_handle(device) -> int:
    """The handle of ``device``'s current stream, which a launch takes."""
    return torch.cuda.current_stream(device).cuda_stream


def scratch(kernel: Hashable, device, stream: int, words: int,
            dtype: torch.dtype) -> torch.Tensor:
    """The scratch of ``kernel``'s launches on ``stream`` of ``device``: at
    least ``words`` words of ``dtype``, zero at creation, and made anew,
    zeroed, when a launch asks for more words than it holds.

    Three rules make it safe. Every launch leaves it zero: the kernel's
    last block resets what the launch used, so no memset precedes a
    launch. Launches that can overlap run on different streams, so they
    never share one (launches on one stream run in order and may). A CUDA
    graph replays only on the stream it was captured on, so the scratch
    whose pointer it keeps is the one of its stream."""
    key = (torch.device(device), int(stream), kernel)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < words:
        buf = _scratch[key] = torch.zeros(words, dtype=dtype, device=device)
    return buf


def query(lib: ctypes.CDLL, fn: str, idx: int, outs: int,
          *args) -> Tuple[int, ...]:
    """The ``outs`` ints that ``lib``'s ``fn(idx, *args, &out...)`` writes
    for device ``idx``, asked once per device and arguments; raises where
    the card refuses the question."""
    key = (fn, idx, args)
    if key not in _facts:
        vals = [ctypes.c_int(0) for _ in range(outs)]
        raise_on(getattr(lib, fn)(idx, *args, *map(ctypes.byref, vals)), lib,
                 fn)
        _facts[key] = tuple(v.value for v in vals)
    return _facts[key]
