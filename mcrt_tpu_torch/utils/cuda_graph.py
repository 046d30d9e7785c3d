"""A step captured once as a CUDA graph, and launch counts that stay true under it.

The JAX package compiles a chunk's bounce loop into one device program
(`jax.jit` over a `lax.while_loop`). The port's counterpart captures one step
of the loop as a CUDA graph (`torch.cuda.CUDAGraph`) and replays it: one launch
of the whole step in place of one launch per op.

A kernel wrapper counts its launches with a `LaunchCounter`. While the current
stream is being captured, a launch only records the kernel into the graph and
runs nothing: it goes to `captured`, not to `launches`. Each
`CapturedStep.replay` then adds to `launches` the launches its graph holds, so
`launches` counts the kernels that ran, eagerly or in a replay.
"""
from __future__ import annotations

import torch

# Every LaunchCounter made: one per kernel wrapper, made when its module is imported.
_COUNTERS: list[LaunchCounter] = []


class LaunchCounter:
    """A kernel's launches that ran (`launches`) and that were recorded into a
    graph under capture (`captured`)."""

    def __init__(self):
        self.launches = 0
        self.captured = 0
        _COUNTERS.append(self)

    def count(self):
        """One launch of the kernel on the current CUDA stream."""
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1


def copy_into(dst, src):
    """Copy each tensor of the tuple `src` into its buffer in `dst`, skipping
    the ones that already are their buffer (a step that updates in place)."""
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


class CapturedStep:
    """`fn(state) -> state` captured once as a CUDA graph over `state`.

    `state` is a tuple of CUDA tensors that serve as the graph's static
    buffers: inside the capture each output of `fn` is copied back into its
    buffer, so one `replay()` advances the state by one step in place. The
    caller writes a new start into the buffers with `copy_into`. A capture that
    fails raises (an op that syncs the host, a kernel that is refused); nothing
    falls back to eager calls.

    `pool_bytes` is what the graph's private memory pool reserved: one step's
    temporaries. `per_replay` is [(counter, launches a replay runs)]. `close()`
    releases the graph and, once no tensor of the pool is referenced, the pool.
    """

    def __init__(self, fn, state):
        dev = state[0].device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = [c.captured for c in _COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            copy_into(state, fn(state))
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.per_replay = [(c, c.captured - n) for c, n in zip(_COUNTERS, before) if c.captured > n]

    def replay(self):
        self.graph.replay()
        for counter, n in self.per_replay:
            counter.launches += n

    def close(self):
        self.graph.reset()
