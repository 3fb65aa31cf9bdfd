"""Small geometry helpers (counterpart of ``diff::utils::matsz``,
reference ``server/include/utils.hpp:7-16``). A copy of the JAX
package's ``utils/shapes.py`` (host-only)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MatSize:
    height: int
    width: int

    @property
    def area(self) -> int:
        return self.height * self.width
