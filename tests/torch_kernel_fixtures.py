"""Fixtures of the port's kernel tests that need no card.

A test module imports a fixture by name
(``from torch_kernel_fixtures import no_kernel_build``) and pytest finds
it there.
"""

import pytest


@pytest.fixture
def no_kernel_build(monkeypatch):
    """No library of ``csrc/`` can be built (no nvcc): the one cache of
    bound libraries (``kernels.build``) starts empty and every build
    raises ``RuntimeError("nvcc not found")``."""
    from cudavideostream_tpu_torch.kernels import build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "library_path",
                        lambda name: build.BUILD_DIR / "absent.so")
