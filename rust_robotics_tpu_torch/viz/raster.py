"""Software rasterizer + GIF recorder.

The port's copy of rust_robotics_tpu/viz/raster.py (host NumPy, no device
work). Reference: crates/rust_robotics_viz/src/gif_recorder.rs:47-420 —
`GifCanvasConfig` (size + world extents + frame delay), `GifFrame` with
draw_path_xy / draw_points_xy / draw_ellipse / draw_robot / draw_grid, and
`GifRecorder` streaming palette-quantized frames; and visualizer.rs
(gnuplot wrapper) whose save_png/save_svg role is covered by the PNG and
SVG export helpers.

Rendering is presentation, not compute: the rasterizer is host-side NumPy
(vectorized line/ellipse stamping). `GifRecorder` streams through the
port's native C++ encoder (`rust_robotics_tpu_torch/native`) where it is
built, as the JAX package's does, and buffers frames for PIL where it is
not; PNG encoding uses PIL, imported by the function that encodes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Color = Tuple[int, int, int]

GROUND_TRUTH: Color = (60, 120, 216)
ESTIMATED: Color = (216, 84, 60)
OBSTACLE: Color = (40, 40, 40)
MEASUREMENT: Color = (200, 200, 200)


@dataclasses.dataclass(frozen=True)
class CanvasConfig:
    """GifCanvasConfig (gif_recorder.rs): pixel size + world extents."""

    width: int = 480
    height: int = 480
    x_range: Tuple[float, float] = (-10.0, 10.0)
    y_range: Tuple[float, float] = (-10.0, 10.0)
    delay_cs: int = 6
    background: Color = (255, 255, 255)


class Frame:
    """One RGB frame with world-coordinate draw primitives."""

    def __init__(self, cfg: CanvasConfig):
        self.cfg = cfg
        self.rgb = np.full(
            (cfg.height, cfg.width, 3), cfg.background, dtype=np.uint8
        )

    def _to_px(self, x, y):
        cfg = self.cfg
        u = (np.asarray(x) - cfg.x_range[0]) / (cfg.x_range[1] - cfg.x_range[0])
        v = (np.asarray(y) - cfg.y_range[0]) / (cfg.y_range[1] - cfg.y_range[0])
        px = np.round(u * (cfg.width - 1)).astype(int)
        py = np.round((1.0 - v) * (cfg.height - 1)).astype(int)
        return px, py

    def _stamp(self, px, py, color, radius_px=1):
        h, w, _ = self.rgb.shape
        r = max(int(radius_px), 0)
        for dx in range(-r, r + 1):
            for dy in range(-r, r + 1):
                if dx * dx + dy * dy > r * r:
                    continue
                xs = np.clip(px + dx, 0, w - 1)
                ys = np.clip(py + dy, 0, h - 1)
                inb = (px + dx >= 0) & (px + dx < w) & (py + dy >= 0) & (py + dy < h)
                self.rgb[ys[inb], xs[inb]] = color

    def draw_points_xy(self, xs, ys, color: Color, size=1.5):
        px, py = self._to_px(xs, ys)
        self._stamp(px, py, color, radius_px=int(round(size / 2)))

    def draw_path_xy(self, xs, ys, color: Color, width=1.5):
        xs = np.asarray(xs, float)
        ys = np.asarray(ys, float)
        if len(xs) < 2:
            return self.draw_points_xy(xs, ys, color, width)
        # dense parametric sampling per segment (vectorized "Bresenham")
        seg_px = max(self.cfg.width, self.cfg.height)
        t = np.linspace(0.0, 1.0, 32)
        x = (xs[:-1, None] + t * (xs[1:, None] - xs[:-1, None])).ravel()
        y = (ys[:-1, None] + t * (ys[1:, None] - ys[:-1, None])).ravel()
        px, py = self._to_px(x, y)
        self._stamp(px, py, color, radius_px=int(round(width / 2)))

    def draw_circle(self, cx, cy, radius, color: Color, width=1.5):
        th = np.linspace(0, 2 * np.pi, 90)
        self.draw_path_xy(cx + radius * np.cos(th), cy + radius * np.sin(th),
                          color, width)

    def draw_ellipse(self, cx, cy, a, b, angle, color: Color, width=1.5):
        """2σ covariance ellipse (gif_recorder.rs draw_ellipse)."""
        th = np.linspace(0, 2 * np.pi, 90)
        ex = a * np.cos(th)
        ey = b * np.sin(th)
        c, s = np.cos(angle), np.sin(angle)
        self.draw_path_xy(cx + c * ex - s * ey, cy + s * ex + c * ey, color,
                          width)

    def draw_robot(self, x, y, yaw, size, color: Color):
        """Triangle glyph oriented along yaw (gif_recorder.rs draw_robot)."""
        pts = np.array(
            [[size, 0.0], [-0.6 * size, 0.45 * size], [-0.6 * size, -0.45 * size],
             [size, 0.0]]
        )
        c, s = np.cos(yaw), np.sin(yaw)
        rot = pts @ np.array([[c, s], [-s, c]])
        self.draw_path_xy(x + rot[:, 0], y + rot[:, 1], color, 1.5)

    def draw_grid(self, blocked, min_x, min_y, resolution,
                  color: Color = OBSTACLE):
        """Fill blocked occupancy cells (gif_recorder.rs draw_grid)."""
        bx, by = np.nonzero(np.asarray(blocked))
        if len(bx) == 0:
            return
        self.draw_points_xy(
            min_x + (bx + 0.5) * resolution, min_y + (by + 0.5) * resolution,
            color, size=max(2.0, resolution * self.cfg.width /
                            (self.cfg.x_range[1] - self.cfg.x_range[0])),
        )


class GifRecorder:
    """Streaming animated-GIF writer (gif_recorder.rs GifRecorder).

    Uses the native C++ encoder where it is built — frames hit the file as
    they arrive, as in the reference's dependency-free recorder — and
    otherwise palette-quantizes and buffers frames for PIL to encode in
    `finish`."""

    def __init__(self, path, cfg: CanvasConfig):
        from rust_robotics_tpu_torch import native

        self.path = str(path)
        self.cfg = cfg
        self._frames = []
        self._durations = []
        self._native = None
        if native.available():
            self._native = native.NativeGifWriter(self.path, cfg.width,
                                                  cfg.height)

    def add_frame(self, frame: Frame):
        self.add_frame_with_delay(frame, self.cfg.delay_cs)

    def add_frame_with_delay(self, frame: Frame, delay_cs: int):
        if self._native is not None:
            self._native.add_frame(frame.rgb, delay_cs)
            return
        from PIL import Image

        self._frames.append(Image.fromarray(frame.rgb).quantize(colors=64))
        self._durations.append(delay_cs * 10)  # cs -> ms

    def finish(self):
        if self._native is not None:
            frames = self._native.close()
            self._native = None
            if frames == 0:
                raise ValueError("no frames recorded")
            return self.path
        if not self._frames:
            raise ValueError("no frames recorded")
        self._frames[0].save(
            self.path,
            save_all=True,
            append_images=self._frames[1:],
            duration=self._durations,
            loop=0,
        )
        return self.path


def save_png(frame: Frame, path):
    from PIL import Image

    Image.fromarray(frame.rgb).save(str(path))
    return str(path)


class SvgCanvas:
    """Vector twin of `Frame`: world-coordinate draw primitives emitted as
    SVG elements — the role of the reference's Visualizer save_svg
    (viz/src/visualizer.rs:111-330) without a gnuplot dependency."""

    def __init__(self, cfg: CanvasConfig):
        self.cfg = cfg
        self._elems = []

    def _to_px(self, x, y):
        cfg = self.cfg
        u = (float(x) - cfg.x_range[0]) / (cfg.x_range[1] - cfg.x_range[0])
        v = (float(y) - cfg.y_range[0]) / (cfg.y_range[1] - cfg.y_range[0])
        return u * cfg.width, (1.0 - v) * cfg.height

    @staticmethod
    def _css(color):
        return f"rgb({color[0]},{color[1]},{color[2]})"

    def draw_path(self, xs, ys, color=(0, 0, 255), width=1.5):
        pts = " ".join(
            "%.2f,%.2f" % self._to_px(x, y) for x, y in zip(xs, ys)
        )
        self._elems.append(
            f'<polyline points="{pts}" fill="none" '
            f'stroke="{self._css(color)}" stroke-width="{width}"/>'
        )

    def draw_circle(self, x, y, radius_world, color=(255, 0, 0),
                    fill=False):
        px, py = self._to_px(x, y)
        r = radius_world * self.cfg.width / (
            self.cfg.x_range[1] - self.cfg.x_range[0]
        )
        f = self._css(color) if fill else "none"
        self._elems.append(
            f'<circle cx="{px:.2f}" cy="{py:.2f}" r="{r:.2f}" '
            f'fill="{f}" stroke="{self._css(color)}"/>'
        )

    def draw_points(self, xs, ys, color=(0, 0, 0), size=2.0):
        for x, y in zip(xs, ys):
            px, py = self._to_px(x, y)
            self._elems.append(
                f'<circle cx="{px:.2f}" cy="{py:.2f}" r="{size:.1f}" '
                f'fill="{self._css(color)}"/>'
            )

    def draw_robot(self, x, y, yaw, size_world=0.5, color=(0, 128, 0)):
        import math

        px, py = self._to_px(x, y)
        hx, hy = self._to_px(
            x + size_world * math.cos(yaw), y + size_world * math.sin(yaw)
        )
        self.draw_circle(x, y, size_world, color)
        self._elems.append(
            f'<line x1="{px:.2f}" y1="{py:.2f}" x2="{hx:.2f}" '
            f'y2="{hy:.2f}" stroke="{self._css(color)}" stroke-width="2"/>'
        )

    def save(self, path):
        cfg = self.cfg
        bg = self._css(cfg.background)
        body = "\n".join(self._elems)
        svg = (
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{cfg.width}" '
            f'height="{cfg.height}">\n'
            f'<rect width="100%" height="100%" fill="{bg}"/>\n'
            f"{body}\n</svg>\n"
        )
        with open(str(path), "w") as f:
            f.write(svg)
        return str(path)
