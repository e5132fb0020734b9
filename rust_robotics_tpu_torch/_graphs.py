"""CUDA graphs of launch-bound loops.

Many of the port's loops launch hundreds of small kernels a step and read
nothing back inside it, so on the card their time is the host's launches.
A CUDA graph captured once replays those kernels — the same kernels on
the same shapes, in the same order, so bitwise the eager run — for one
launch. Only CUDA tensors are captured; the callers run eagerly on the CPU.
"""

from __future__ import annotations

import torch


class Graphed:
    """fn(*args) captured on static copies of its tensor arguments: a call
    copies its arguments in and replays. The result is the graph's output,
    rewritten by the next call. fn runs once first on a side stream (the
    warm-up of `torch.cuda.graph`'s documentation), then is captured by
    `torch.cuda.graph`."""

    def __init__(self, fn, *args):
        self.args = [a.clone() for a in args]
        with torch.cuda.device(self.args[0].device if self.args else torch.cuda.current_device()):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*self.args)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = fn(*self.args)

    def __call__(self, *args):
        for dst, src in zip(self.args, args):
            dst.copy_(src)
        self.graph.replay()
        return self.out


def meta(t):
    """A tensor's part of a graph's key: its shape, dtype and device (None
    for None)."""
    return None if t is None else (t.shape, t.dtype, t.device)


def kept(cache, key, make, keep):
    """cache[key] (an OrderedDict), made by make() where missing, as its
    most recently used entry; the `keep` most recent entries stay."""
    value = cache.pop(key, None)
    if value is None:
        value = make()
    cache[key] = value
    while len(cache) > keep:
        cache.popitem(last=False)
    return value
