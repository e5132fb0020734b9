"""Dataset loaders (the port's own numpy copies of rust_robotics_tpu/data):
EuRoC MAV (`euroc.py`), KITTI odometry (`kitti.py`) and the locator of the
reference's checked-in mini fixtures (`fixtures.py`)."""
