"""Array-native geometry rasterizer for building permittivity scenes.

Counterpart of ``fdtd2d_tpu/core/geometry.py``, copied: NumPy only, so the
port keeps its own copy rather than import the JAX package. Capability-equivalent of the reference's PIL-based ``RegionDrawer``
(reference: python-src/region_drawer.py:1-129) — straight/curved waveguides,
ring resonators, filled spheres, directional couplers — but rendered directly
into a float occupancy array with exact signed-distance tests instead of PIL
draw calls, so scenes can be generated headless and converted straight into
permittivity maps (no image round-trip needed). A PNG export is kept
for parity with the reference workflow.

Convention: canvas value 1.0 = material ("black"), 0.0 = vacuum ("white").
Coordinates are (x, y) = (column, row), matching the reference's PIL usage.
"""

from __future__ import annotations

import numpy as np

from fdtd2d_tpu_torch import constants


def _segment_mask(xx, yy, p0, p1, half_width):
    """Boolean mask of points within ``half_width`` of segment p0-p1."""
    px, py = float(p0[0]), float(p0[1])
    qx, qy = float(p1[0]), float(p1[1])
    dx, dy = qx - px, qy - py
    denom = dx * dx + dy * dy
    if denom == 0.0:
        dist2 = (xx - px) ** 2 + (yy - py) ** 2
    else:
        t = np.clip(((xx - px) * dx + (yy - py) * dy) / denom, 0.0, 1.0)
        dist2 = (xx - (px + t * dx)) ** 2 + (yy - (py + t * dy)) ** 2
    return dist2 <= half_width * half_width


class RegionDrawer:
    """Draw photonic structures into an occupancy array."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.canvas = np.zeros((height, width), dtype=np.float64)
        yy, xx = np.mgrid[0:height, 0:width]
        self._xx = xx.astype(np.float64)
        self._yy = yy.astype(np.float64)

    # -- primitives --------------------------------------------------------

    def _stamp(self, mask) -> None:
        self.canvas[mask] = 1.0

    def draw_waveguide(self, start, end, width: int) -> None:
        """Straight waveguide of the given stroke width between two points."""
        self._stamp(_segment_mask(self._xx, self._yy, start, end, width / 2.0))

    def draw_ring_resonator(self, center, radius: int, ring_width: int) -> None:
        """Annulus (ring outline) centered at ``center``."""
        r = np.hypot(self._xx - center[0], self._yy - center[1])
        outer = radius + ring_width / 2.0
        inner = max(outer - ring_width, 0.0)
        self._stamp((r <= outer) & (r >= inner))

    def draw_sphere(self, center, radius: int, sphere_width: int = 0) -> None:
        """Filled disk; ``sphere_width`` pads the radius like the reference."""
        r = np.hypot(self._xx - center[0], self._yy - center[1])
        self._stamp(r <= radius + sphere_width / 2.0)

    def draw_curved_waveguide(self, start, end, control_point, width: int, samples: int = 100) -> None:
        """Quadratic Bezier waveguide, stroked as a polyline of segments."""
        t = np.linspace(0.0, 1.0, samples)
        bx = (1 - t) ** 2 * start[0] + 2 * (1 - t) * t * control_point[0] + t**2 * end[0]
        by = (1 - t) ** 2 * start[1] + 2 * (1 - t) * t * control_point[1] + t**2 * end[1]
        mask = np.zeros_like(self.canvas, dtype=bool)
        for k in range(samples - 1):
            mask |= _segment_mask(self._xx, self._yy, (bx[k], by[k]), (bx[k + 1], by[k + 1]), width / 2.0)
        self._stamp(mask)

    def draw_directional_coupler(self, start, length: int, gap: int, waveguide_width: int) -> None:
        """Two parallel horizontal waveguides separated by ``gap``."""
        y_offset = gap // 2 + waveguide_width // 2
        self.draw_waveguide((start[0], start[1] - y_offset), (start[0] + length, start[1] - y_offset), waveguide_width)
        self.draw_waveguide((start[0], start[1] + y_offset), (start[0] + length, start[1] + y_offset), waveguide_width)

    def draw_box(self, top_left, size: int, wall_thickness: int) -> None:
        """Four-walled cavity box (the reference's __main__ demo scene)."""
        x0, y0 = top_left
        half = wall_thickness // 2
        self.draw_waveguide((x0 - half, y0), (x0 + size + half, y0), wall_thickness)
        self.draw_waveguide((x0 - half, y0 + size), (x0 + size + half, y0 + size), wall_thickness)
        self.draw_waveguide((x0, y0 - half), (x0, y0 + size + half), wall_thickness)
        self.draw_waveguide((x0 + size, y0 - half), (x0 + size, y0 + size + half), wall_thickness)

    # -- exports -----------------------------------------------------------

    def to_factor(self, black_point: float = 10.0) -> np.ndarray:
        """Relative-permittivity factor map in [1, black_point]."""
        return 1.0 + (black_point - 1.0) * self.canvas

    def to_eps(self, black_point: float = 10.0) -> np.ndarray:
        """Absolute permittivity map (material -> black_point * eps0)."""
        return self.to_factor(black_point) * constants.EPSILON_0

    def save(self, filename: str) -> None:
        """Save as a grayscale PNG (material=black) for image-based workflows."""
        from PIL import Image

        gray = ((1.0 - self.canvas) * 255.0).astype(np.uint8)
        Image.fromarray(gray, mode="L").save(filename)
