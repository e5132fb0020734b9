"""rust_robotics_tpu_torch — the PyTorch / CUDA port of rust_robotics_tpu.

The JAX package `rust_robotics_tpu` is the reference; this package mirrors
its layout (`core/`, `models/`, `ops/`, `filters/`, `planning/`, `nlls/`,
`slam/`, `data/`, `parallel/`, `demos/`) with the same
module and function names, so each function has an obvious counterpart.

Idiom: the JAX pytree dataclasses become frozen dataclasses of tensors with
the batch in the leading dims; `vmap` becomes explicit batch dims and
`scan`/`fori_loop` a Python loop; randomness comes from a `torch.Generator`.
Entry points that create tensors take `device=` and `dtype=` and run on
`cuda` unless asked for the CPU (`_device.resolve_device`).

Every Pallas kernel of the reference becomes a CUDA kernel written for
Hopper (`csrc/`), built by `ops/_build.py` at first use and launched by a
wrapper that takes its plain-PyTorch twin only for CPU tensors.
"""

__version__ = "0.1.0"
