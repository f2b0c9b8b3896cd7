"""Hierarchical phase timing (the analogue of plonky2's TimingTree).

Usage:
    tt = TimingTree("prove", device)
    with tt.scope("commit"):
        ...
    print(tt.render())
    tt.as_dict()  # for structured logging / bench JSON

On a CUDA device every scope boundary calls torch.cuda.synchronize(), so a
phase's time includes the device work it launched (launches are
asynchronous; without the barrier a multi-second commit reads as a few
milliseconds and its time lands in whichever later phase first waits).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class _Node:
    def __init__(self, name: str):
        self.name = name
        self.elapsed = 0.0
        self.children: list[_Node] = []


class TimingTree:
    def __init__(self, name: str = "root", device=None):
        self.root = _Node(name)
        self._stack = [self.root]
        self._device = torch.device(device) if device is not None else None
        self._barrier()
        self._t0 = time.perf_counter()

    def _barrier(self):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @contextmanager
    def scope(self, name: str):
        self._barrier()
        node = _Node(name)
        self._stack[-1].children.append(node)
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._barrier()
            node.elapsed = time.perf_counter() - t0
            self._stack.pop()

    def finish(self):
        self._barrier()
        self.root.elapsed = time.perf_counter() - self._t0

    def render(self) -> str:
        if self.root.elapsed == 0.0:
            self.finish()
        lines: list[str] = []

        def walk(node: _Node, depth: int):
            lines.append(f"{'  ' * depth}{node.elapsed * 1e3:9.1f}ms  {node.name}")
            for c in node.children:
                walk(c, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)

    def as_dict(self) -> dict:
        if self.root.elapsed == 0.0:
            self.finish()

        def walk(node: _Node):
            d = {"name": node.name, "ms": node.elapsed * 1e3}
            if node.children:
                d["children"] = [walk(c) for c in node.children]
            return d

        return walk(self.root)
