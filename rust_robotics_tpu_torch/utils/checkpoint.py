"""Checkpoint/resume for long-running filter and optimizer state.

The port of rust_robotics_tpu/utils/checkpoint.py, which writes orbax
checkpoints of pytrees. Here a state is a nested dict (lists and tuples
too) of tensors, written with `torch.save` to `directory/step_N` and read
back with `weights_only=True` against a template, as orbax restores
against an abstract target: each leaf takes the template's device and
dtype, and a shape that differs from the template's raises.
"""

from __future__ import annotations

import os

import torch

_FILE = "state.pt"


def _path(directory, step: int) -> str:
    return os.path.join(os.path.abspath(str(directory)), f"step_{step}")


def save_checkpoint(directory, step: int, state):
    """Write nested-dict `state` at `directory/step_N`; returns that path."""
    path = _path(directory, step)
    os.makedirs(path, exist_ok=True)
    host = _map(lambda t, _: t.detach().cpu() if isinstance(t, torch.Tensor) else t, state, state)
    torch.save(host, os.path.join(path, _FILE))
    return path


def _map(fn, tree, like, where=""):
    """fn(leaf, template leaf) over `tree`, walked along `like`."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"checkpoint structure differs from the template at {where or '/'}")
        return {k: _map(fn, tree[k], like[k], f"{where}[{k!r}]") for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"checkpoint structure differs from the template at {where or '/'}")
        out = [_map(fn, t, lk, f"{where}[{i}]") for i, (t, lk) in enumerate(zip(tree, like))]
        return type(like)(*out) if hasattr(like, "_fields") else type(like)(out)
    return fn(tree, like)


def load_checkpoint(directory, step: int, like):
    """Restore the state saved at step N, with `like` as the structure,
    shape, dtype and device template."""
    saved = torch.load(os.path.join(_path(directory, step), _FILE), weights_only=True)

    def restore(leaf, template):
        if not isinstance(template, torch.Tensor):
            return leaf
        leaf = torch.as_tensor(leaf)
        if tuple(leaf.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(leaf.shape)} where the template "
                             f"has {tuple(template.shape)}")
        return leaf.to(device=template.device, dtype=template.dtype)

    return _map(restore, saved, like)


def latest_step(directory):
    """Largest step_N present, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name.split("_", 1)[1])
        for name in os.listdir(directory)
        if name.startswith("step_") and name.split("_", 1)[1].isdigit()
    ]
    return max(steps) if steps else None
