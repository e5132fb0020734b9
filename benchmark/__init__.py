"""The benchmark of the PyTorch and CUDA port (`rust_robotics_tpu_torch`).

`run.py` is its command; `BENCHMARK.json` at the checkout's root names its
cells and metrics. Nothing here imports JAX or the JAX package.
"""
