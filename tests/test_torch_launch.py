"""The launch seam of the port's kernels (``kernels/launch.py``) on the
CPU: every ``csrc/*.cu`` has one binding table (``ops.kernel_sources``);
each table's functions match their C definitions in kind and count of
arguments; binding a library declares every function of its table,
checks each geometry export against the ops module's constant (one off
by one is refused, naming the source and the export) and caches the
bound library once, in ``kernels.build``'s cache; the one raise on a
failed call; the once-per-device queries.

The libraries themselves are built and bound on the card by
``chip_smoke.py``.
"""

import ctypes
import re
import types
from pathlib import Path

import pytest

from cudavideostream_tpu_torch import ops
from cudavideostream_tpu_torch.kernels import build, launch

SOURCES = ops.kernel_sources()


def _c_functions(name):
    """``{function: [argument kinds]}`` of the ``int cvs_*(...)``
    definitions in ``csrc/<name>.cu``, each argument ``"i"`` (int),
    ``"ll"`` (long long) or ``"p"`` (a pointer or a stream)."""
    code = re.sub(r"//[^\n]*", "", (build.CSRC_DIR / f"{name}.cu").read_text())
    out = {}
    for fn, params in re.findall(r"\bint\s+(cvs_\w+)\s*\(([^)]*)\)\s*\{",
                                 code):
        kinds = []
        for p in params.split(","):
            p = re.sub(r"\s+\w+$", "", p.strip())
            if p in ("", "void"):
                continue
            kinds.append("p" if "*" in p or p == "cudaStream_t"
                         else {"int": "i", "long long": "ll"}[p])
        out[fn] = kinds
    return out


def _kind(ctype):
    return {launch.I: "i", launch.LL: "ll", launch.P: "p",
            launch.OUT: "p"}[ctype]


class _Fn:
    """A C function as ``ctypes`` exposes it: declarable, and answering
    ``value`` to every call."""

    def __init__(self, value=0):
        self.value = value
        self.argtypes = self.restype = None

    def __call__(self, *args):
        return self.value


def _fake(src, off=None):
    """A library of ``src``'s functions; its geometry export ``off``
    answers one more than the ops module's constant."""
    lib = types.SimpleNamespace(cvs_error_string=_Fn(b"invalid argument"))
    for fn in src.functions:
        setattr(lib, fn, _Fn())
    for fn, want in src.constants.items():
        setattr(lib, fn, _Fn(want + (fn == off)))
    return lib


def test_every_source_has_one_table():
    names = [src.name for src in SOURCES]
    assert len(set(names)) == len(names)
    assert set(names) == {p.stem for p in build.CSRC_DIR.glob("*.cu")}


@pytest.mark.parametrize("src", SOURCES, ids=lambda s: s.name)
def test_table_matches_the_c_functions(src):
    """Each function of the table is defined in the source with arguments
    of the same kinds in the same order, and each geometry export takes
    none; the table names no function twice."""
    defined = _c_functions(src.name)
    assert not set(src.functions) & set(src.constants)
    for fn, args in src.functions.items():
        assert [_kind(a) for a in args] == defined[fn], fn
    for fn in src.constants:
        assert defined[fn] == [], fn


@pytest.mark.parametrize("src", SOURCES, ids=lambda s: s.name)
def test_binding_checks_every_geometry_export(src, monkeypatch):
    """A library whose geometry export is off by one is refused, naming
    the source and the export, and is not cached; the library that agrees
    is bound (every function of the table and ``cvs_error_string``
    declared), cached in ``build``'s cache and returned again unbound."""
    made = []
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build", lambda name: Path(f"{name}.so"))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: made.pop())
    for fn, want in src.constants.items():
        made.append(_fake(src, off=fn))
        with pytest.raises(RuntimeError,
                           match=rf"csrc/{src.name}\.cu .*{fn}\(\) is "
                                 rf"{want + 1}, the constant is {want}"):
            launch.library(src)
        assert build._loaded == {}
    lib = _fake(src)
    made.append(lib)
    assert launch.library(src) is lib
    for fn, args in src.functions.items():
        f = getattr(lib, fn)
        assert (f.argtypes, f.restype) == (list(args), ctypes.c_int), fn
    for fn in src.constants:
        assert getattr(lib, fn).argtypes == [], fn
    assert lib.cvs_error_string.restype is ctypes.c_char_p
    getattr(lib, next(iter(src.functions))).argtypes = None
    assert launch.library(src) is lib and build._loaded == {src.name: lib}
    assert getattr(lib, next(iter(src.functions))).argtypes is None


def test_raise_on_names_the_call_and_the_error():
    lib = _fake(SOURCES[0])
    launch.raise_on(0, lib, "overlay")
    with pytest.raises(RuntimeError, match=r"^overlay kernel launch failed: "
                                           r"invalid argument \(1\)$"):
        launch.raise_on(1, lib, "overlay")


def test_a_query_is_asked_once_per_device_and_arguments(monkeypatch):
    """``query`` asks the library once per (function, device, arguments)
    and returns the ints it wrote; a refusal raises and is not kept."""
    monkeypatch.setattr(launch, "_facts", {})
    asked = []

    def blocks(idx, variant, out):
        asked.append((idx, variant))
        out._obj.value = 10 * idx + variant
        return rc

    rc = 0
    lib = types.SimpleNamespace(cvs_flat_blocks=blocks,
                                cvs_error_string=_Fn(b"no device"))
    assert launch.query(lib, "cvs_flat_blocks", 1, 1, 0) == (10,)
    assert launch.query(lib, "cvs_flat_blocks", 1, 1, 0) == (10,)
    assert launch.query(lib, "cvs_flat_blocks", 1, 1, 1) == (11,)
    assert launch.query(lib, "cvs_flat_blocks", 2, 1, 0) == (20,)
    assert asked == [(1, 0), (1, 1), (2, 0)]
    rc = 3
    with pytest.raises(RuntimeError, match=r"cvs_flat_blocks kernel launch "
                                           r"failed: no device \(3\)"):
        launch.query(lib, "cvs_flat_blocks", 3, 1, 0)
    assert ("cvs_flat_blocks", 3, (0,)) not in launch._facts
