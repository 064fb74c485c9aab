"""Camera intrinsics (numpy-only copy of ``colvo/data/intrinsics.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @classmethod
    def from_matrix(cls, k: np.ndarray, width: int, height: int) -> "Intrinsics":
        return cls(float(k[0, 0]), float(k[1, 1]), float(k[0, 2]), float(k[1, 2]), width, height)

    @property
    def matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def inverse(self) -> np.ndarray:
        return np.linalg.inv(self.matrix).astype(np.float32)

    def scaled(self, new_width: int, new_height: int) -> "Intrinsics":
        """Rescale to a new image size (focal lengths and principal point
        scale linearly with resolution)."""
        sx = new_width / self.width
        sy = new_height / self.height
        return Intrinsics(
            self.fx * sx, self.fy * sy, self.cx * sx, self.cy * sy, new_width, new_height
        )


def scale_intrinsics(k: np.ndarray, sx: float, sy: float) -> np.ndarray:
    """Scale a 3×3 K for a resized image."""
    out = k.copy().astype(np.float32)
    out[0, :] *= sx
    out[1, :] *= sy
    return out
