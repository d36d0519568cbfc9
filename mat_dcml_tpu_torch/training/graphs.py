"""Replay a fixed-shape step of an update as one CUDA graph.

HAPPO and HATRPO train the agents one after another (``training/happo.py``),
and a turn is a few hundred small kernels a minibatch step issued from
Python: on the card the host's launch rate, not the device, sets the
update's time.  Every turn has the same shapes, so :class:`CapturedCall`
captures the turn's function once (``torch.cuda.graph``, after warm-up runs
on a side stream, as PyTorch's whole-network capture does, the backward
included) and replays it with each turn's inputs copied into its static
input tensors.  The arithmetic is the eager function's, kernel for kernel.

The function must be free of host synchronisation and keep its shapes; its
outputs are the graph's own tensors, overwritten by the next replay, so the
caller copies what it keeps.  On the CPU the function runs eagerly.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

WARMUP_RUNS = 2


def _static_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone().requires_grad_(x.requires_grad)
    return x


class CapturedCall:
    """``fn(*args)`` captured on its first CUDA call, replayed after; ``args``
    is a tree of tensors (tuples, NamedTuples, dicts) whose shapes never
    change between calls."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graph = None
        self.static = None
        self.out = None

    def _capture(self, args) -> None:
        self.static = tuple(tree_unflatten([_static_copy(x) for x in leaves], spec)
                            for leaves, spec in map(tree_flatten, args))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.fn(*self.static)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self.fn(*self.static)

    def __call__(self, *args):
        if self.graph is None:
            self._capture(args)
        with torch.no_grad():
            for dst, src in zip(tree_flatten(self.static)[0], tree_flatten(args)[0]):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)
        self.graph.replay()
        return self.out
