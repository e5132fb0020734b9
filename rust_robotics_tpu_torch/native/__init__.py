"""Native C++ host runtime (ctypes bindings).

The port of rust_robotics_tpu/native/__init__.py. The reference's host
runtime is native Rust: the MovingAI benchmark loader
(planning/src/moving_ai.rs:21-151,178-230), g2o pose-graph text I/O
(slam/src/g2o.rs:48-137), and a dependency-free GIF rasterizer/encoder
(viz/src/gif_recorder.rs:47-420). `host_runtime.cpp` (C++17, zero
dependencies, the port's own copy of the JAX package's) is built on first
use by g++ through `ops/_build.py::build_host` into
`rust_robotics_tpu_torch/_build/`, named by a hash of the source, and bound
with ctypes. This is host code, not a device kernel: it runs on the CPU on
every machine, and the pure-Python paths stay the reference semantics.

If no library can be built, `available()` is False (the compiler's error
is printed once) and the callers (data/moving_ai.py, slam/g2o.py,
viz/raster.py) keep their pure-Python paths.
"""

from __future__ import annotations

import ctypes
import sys
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("host_runtime.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    p = c.c_void_p
    sigs = {
        "rr_last_error": ([], c.c_char_p),
        "rr_map_parse": ([c.c_char_p, c.c_int64], p),
        "rr_map_width": ([p], c.c_int64),
        "rr_map_height": ([p], c.c_int64),
        "rr_map_passable": ([p, p], None),
        "rr_map_tiles": ([p, p], None),
        "rr_map_free": ([p], None),
        "rr_scen_parse": ([c.c_char_p, c.c_int64], p),
        "rr_scen_count": ([p], c.c_int64),
        "rr_scen_names_len": ([p], c.c_int64),
        "rr_scen_fill": ([p, p, p, p], None),
        "rr_scen_free": ([p], None),
        "rr_g2o_parse": ([c.c_char_p, c.c_int64], p),
        "rr_g2o_counts": ([p, p], None),
        "rr_g2o_fill_se2": ([p, p, p, p, p, p], None),
        "rr_g2o_fill_se3": ([p, p, p, p, p, p], None),
        "rr_g2o_free": ([p], None),
        "rr_gif_open": ([c.c_char_p, c.c_int32, c.c_int32], p),
        "rr_gif_add_frame": ([p, p, c.c_int32], c.c_int32),
        "rr_gif_close": ([p], c.c_int32),
        "rr_gif_quantize_rgb": ([p, c.c_int64, p], None),
        "rr_draw_polyline": (
            [p, c.c_int32, c.c_int32, p, c.c_int64, c.c_int32,
             c.c_uint8, c.c_uint8, c.c_uint8],
            None,
        ),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _get():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            from rust_robotics_tpu_torch.ops import _build

            try:
                _lib = _bind(ctypes.CDLL(str(_build.build_host(SOURCE))))
            except (RuntimeError, OSError, AttributeError) as e:
                print(f"[rust_robotics_tpu_torch.native] unavailable: {e}",
                      file=sys.stderr)
    return _lib


def available() -> bool:
    """Whether the host runtime is built and loaded (builds it on first call)."""
    return _get() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _err(lib) -> str:
    return lib.rr_last_error().decode()


# ---------------------------------------------------------------------------
# MovingAI
# ---------------------------------------------------------------------------

def parse_map_native(text: str):
    """(width, height, passable [h,w] bool, tiles [h,w] '<U1') or None."""
    lib = _get()
    if lib is None:
        return None
    data = text.encode()
    h = lib.rr_map_parse(data, len(data))
    if not h:
        raise ValueError(_err(lib))
    try:
        width = lib.rr_map_width(h)
        height = lib.rr_map_height(h)
        passable = np.empty((height, width), np.uint8)
        tiles_b = np.empty((height, width), "S1")
        lib.rr_map_passable(h, _ptr(passable))
        lib.rr_map_tiles(h, _ptr(tiles_b))
    finally:
        lib.rr_map_free(h)
    return int(width), int(height), passable.astype(bool), tiles_b.astype("U1")


def parse_scenarios_native(text: str):
    """(ints [N,7] int64: bucket,w,h,sx,sy,gx,gy; optimal [N]; names list)
    or None when the native library is unavailable."""
    lib = _get()
    if lib is None:
        return None
    data = text.encode()
    h = lib.rr_scen_parse(data, len(data))
    if not h:
        raise ValueError(_err(lib))
    try:
        n = lib.rr_scen_count(h)
        nlen = lib.rr_scen_names_len(h)
        ints = np.empty((n, 7), np.int64)
        opt = np.empty((n,), np.float64)
        names_b = np.empty((nlen,), np.uint8)
        lib.rr_scen_fill(h, _ptr(ints), _ptr(opt), _ptr(names_b))
    finally:
        lib.rr_scen_free(h)
    names = names_b.tobytes().decode().split("\n") if nlen else []
    return ints, opt, names


# ---------------------------------------------------------------------------
# g2o
# ---------------------------------------------------------------------------

def parse_g2o_native(text: str):
    """Dict of dense arrays (full-symmetric info matrices) or None.

    Keys: v2_ids [N2], v2_pose [N2,3], e2_idx [E2,2], e2_meas [E2,3],
    e2_info [E2,3,3], v3_ids, v3_pose [N3,7], e3_idx, e3_meas [E3,7],
    e3_info [E3,6,6].
    """
    lib = _get()
    if lib is None:
        return None
    data = text.encode()
    h = lib.rr_g2o_parse(data, len(data))
    if not h:
        raise ValueError(_err(lib))
    try:
        counts = np.empty((4,), np.int64)
        lib.rr_g2o_counts(h, _ptr(counts))
        n2, e2, n3, e3 = (int(v) for v in counts)
        out = {
            "v2_ids": np.empty((n2,), np.int64),
            "v2_pose": np.empty((n2, 3), np.float64),
            "e2_idx": np.empty((e2, 2), np.int64),
            "e2_meas": np.empty((e2, 3), np.float64),
            "e2_info": np.empty((e2, 3, 3), np.float64),
            "v3_ids": np.empty((n3,), np.int64),
            "v3_pose": np.empty((n3, 7), np.float64),
            "e3_idx": np.empty((e3, 2), np.int64),
            "e3_meas": np.empty((e3, 7), np.float64),
            "e3_info": np.empty((e3, 6, 6), np.float64),
        }
        lib.rr_g2o_fill_se2(h, _ptr(out["v2_ids"]), _ptr(out["v2_pose"]),
                            _ptr(out["e2_idx"]), _ptr(out["e2_meas"]),
                            _ptr(out["e2_info"]))
        lib.rr_g2o_fill_se3(h, _ptr(out["v3_ids"]), _ptr(out["v3_pose"]),
                            _ptr(out["e3_idx"]), _ptr(out["e3_meas"]),
                            _ptr(out["e3_info"]))
    finally:
        lib.rr_g2o_free(h)
    return out


# ---------------------------------------------------------------------------
# GIF encoder + rasterizer
# ---------------------------------------------------------------------------

class NativeGifWriter:
    """Streaming GIF89a writer: frames hit the file as they arrive (the
    reference's GifRecorder streams too, gif_recorder.rs:380-420), unlike
    the PIL path which keeps every frame in memory until finish()."""

    def __init__(self, path, width: int, height: int):
        lib = _get()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._h = lib.rr_gif_open(str(path).encode(), width, height)
        if not self._h:
            raise OSError(_err(lib))
        self.path = str(path)
        self.width = width
        self.height = height

    def add_frame(self, rgb: np.ndarray, delay_cs: int = 6) -> int:
        rgb = np.ascontiguousarray(rgb, np.uint8)
        if rgb.shape != (self.height, self.width, 3):
            raise ValueError(f"frame shape {rgb.shape} != "
                             f"({self.height},{self.width},3)")
        return self._lib.rr_gif_add_frame(self._h, _ptr(rgb), int(delay_cs))

    def close(self) -> int:
        frames = self._lib.rr_gif_close(self._h)
        self._h = None
        if frames < 0:
            raise OSError("gif close failed")
        return frames


def quantize_rgb_native(rgb: np.ndarray) -> np.ndarray | None:
    """Round-trip an RGB image through the encoder's 6x7x6 palette."""
    lib = _get()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, np.uint8)
    out = np.empty_like(rgb)
    lib.rr_gif_quantize_rgb(_ptr(rgb), rgb.size // 3, _ptr(out))
    return out


def draw_polyline_native(rgb: np.ndarray, pts: np.ndarray, radius: int,
                         color) -> bool:
    """Bresenham polyline with disc stamping, in place. pts: [n,2] (x, y)
    pixel coords. Returns False when the native library is unavailable."""
    lib = _get()
    if lib is None:
        return False
    if not (rgb.flags.c_contiguous and rgb.dtype == np.uint8):
        raise ValueError("rgb must be C-contiguous uint8")
    pts = np.ascontiguousarray(pts, np.int32)
    h, w, _ = rgb.shape
    lib.rr_draw_polyline(_ptr(rgb), w, h, _ptr(pts), pts.shape[0],
                         int(radius), int(color[0]), int(color[1]),
                         int(color[2]))
    return True
