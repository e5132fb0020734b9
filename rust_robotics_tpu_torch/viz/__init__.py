from rust_robotics_tpu_torch.viz.raster import (  # noqa: F401
    CanvasConfig,
    Frame,
    GifRecorder,
)
