"""Dataset loaders (the port's own numpy copies of rust_robotics_tpu/data):
EuRoC MAV (`euroc.py`), KITTI odometry (`kitti.py`), the MovingAI
benchmark maps and scenarios (`moving_ai.py`) and the locator of the
reference's checked-in mini fixtures (`fixtures.py`)."""
