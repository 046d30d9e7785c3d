"""A step captured once as a CUDA graph, and launch counts that stay true under it.

The JAX package compiles a chunk's bounce loop into one device program
(`jax.jit` over a `lax.while_loop`). The port's counterpart captures one step
of the loop as a CUDA graph (`torch.cuda.CUDAGraph`) and replays it: one launch
of the whole step in place of one launch per op.

`GraphedLoop` runs such a loop over static buffers: the first step eagerly,
the second captured, every later one replayed, across every start loaded
into the same buffers, until the loop's stop rule (`running`) says so.

A step that reads a condition of its data on the host (the best-first
traversal, ops/cluster_bvh.py) cannot be captured: its builder
sets `step.capturable = False`, and the loops then call it eagerly on the
card, one launch per op, as on the CPU. `graphed` tells the two apart.

A kernel wrapper counts its launches with a `LaunchCounter`. While the current
stream is being captured, a launch only records the kernel into the graph and
runs nothing: it goes to `captured`, not to `launches`. Each
`CapturedStep.replay` then adds to `launches` the launches its graph holds, so
`launches` counts the kernels that ran, eagerly or in a replay.

The differentiable loops' counterpart (`lax.scan` over `jax.checkpoint`) is
`GraphedTrip`: one trip as two graphs, the trip and its recompute plus
backward, replayed by an autograd Function for every trip of every call of
the same shapes.

Under a recording (utils/trace) the loops add spans and counters to the
render's `stats`: the spans `loop.drain`, `loop.warm` (the eager first step
on the card) and `loop.capture` (a CapturedStep's or a GraphedTrip's
captures); the counters `loop_steps`, `loop_sync_wait_s` (host seconds
blocked on the device: on `running` a step, and on the work queued before
each capture, which so stays out of `loop.capture`) and `graph_pool_bytes`
(the `pool_bytes` the captures reserved, summed when they are reserved).
`loop.load` is the callers' span around `load` and the `initial()` that they
build its start with.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import trace

# Every LaunchCounter made: one per kernel wrapper, made when its module is imported.
_COUNTERS: list[LaunchCounter] = []


class LaunchCounter:
    """A kernel's launches that ran (`launches`) and that were recorded into a
    graph under capture (`captured`)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.launches = 0
        self.captured = 0
        _COUNTERS.append(self)

    def count(self):
        """One launch of the kernel on the current CUDA stream."""
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1


def captures(device) -> bool:
    """Whether loops on `device` capture their steps as CUDA graphs: on the
    card they do (a step that is not capturable still runs eagerly)."""
    return device.type == "cuda"


def copy_into(dst, src):
    """Copy each tensor of the tuple `src` into its buffer in `dst`, skipping
    the ones that already are their buffer (a step that updates in place)."""
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


def wait_for_device(dev):
    """Wait for the work queued on `dev` before a capture, counted in
    `loop_sync_wait_s` with the steps' waits (the queued work is the eager
    first step's and the load's, not the capture's)."""
    t0 = trace.now()
    torch.cuda.synchronize(dev)
    trace.count("loop_sync_wait_s", (trace.now() - t0) * 1e-9)


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
    The capture is the span `loop.capture`, after the wait for the queued
    work (`wait_for_device`), and counts its `graph_pool_bytes`.
    """

    def __init__(self, fn, state):
        dev = state[0].device
        wait_for_device(dev)
        with trace.span("loop.capture"):
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            before = [c.captured for c in _COUNTERS]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                copy_into(state, fn(state))
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            self.per_replay = [(c, c.captured - n) for c, n in zip(_COUNTERS, before)
                               if c.captured > n]
        trace.count("graph_pool_bytes", self.pool_bytes)

    def replay(self):
        self.graph.replay()
        for counter, n in self.per_replay:
            counter.launches += n

    def close(self):
        self.graph.reset()


class GraphedLoop:
    """A loop of `step(state) -> state` run one step at a time over static
    buffers: the shared core of the forward loops (path_tracer.StreamedTrace
    and BatchTrace, the photon mapper's eye passes and emission). `state` is
    a NamedTuple of tensors with an `alive` field.

    load(init) puts a new start into `state`: on the card into the static
    buffers, which the first load allocates (a clone of each field, so fields
    that share a tensor get buffers of their own). advance() runs one step. On
    the card the first advance after construction calls the step eagerly (it
    builds the kernels, runs their first-use queries and settles the
    allocator, none of which may first happen under capture) and leaves its
    result in the buffers; the second captures the step over them
    (CapturedStep); every later advance, of this load and of later ones, is
    one replay. A capture that fails raises. On the CPU, and on the card for
    a step whose `capturable` is False, every advance calls the step on the
    loaded state and nothing is captured; `graphed` says which route the
    last load took. drain() advances while `running(state)`, a device
    boolean read once a step: any lane alive, unless a subclass gives its
    loop's own rule. close() releases the graph and its pool with the
    buffers. drain() is the span `loop.drain`, the eager first step
    `loop.warm` inside it; drain counts `loop_steps` and
    `loop_sync_wait_s`, the host's wait on each step's `running` and
    before the capture."""

    def __init__(self, step):
        self.step = step
        self.capturable = getattr(step, "capturable", True)
        self.graphed = False       # the loop's last load runs the graphed route
        self.state = None
        self.graph = None          # the CapturedStep, once captured
        self._warm = False         # the first step ran eagerly

    def load(self, init):
        self.graphed = self.capturable and captures(init[0].device)
        if not self.graphed:
            self.state = init
        elif self.state is None:
            self.state = type(init)(*(x.clone() for x in init))
        else:
            copy_into(self.state, init)

    def advance(self):
        if not self.graphed:
            self.state = self.step(self.state)
        elif self.graph is not None:
            self.graph.replay()
        elif not self._warm:
            with trace.span("loop.warm"):
                copy_into(self.state, self.step(self.state))
            self._warm = True
        else:
            self.graph = CapturedStep(self.step, self.state)
            self.graph.replay()

    def running(self, state):
        """The loop's condition, a device boolean: any lane alive."""
        return state.alive.any()

    def drain(self) -> int:
        """advance() while `running`, one host sync a step; returns the steps
        run."""
        steps = wait_ns = 0
        with trace.span("loop.drain"):
            while True:
                go = self.running(self.state)
                t0 = trace.now()
                go = bool(go)
                wait_ns += trace.now() - t0
                if not go:
                    break
                self.advance()
                steps += 1
        trace.count("loop_steps", steps)
        trace.count("loop_sync_wait_s", wait_ns * 1e-9)
        return steps

    def close(self):
        if self.graph is not None:
            self.graph.close()
        self.graph, self.state, self._warm = None, None, False


def _distinct_tensors(tree):
    """(tensors, pattern, spec) of a pytree: its distinct tensors in order of
    first appearance, and per flattened leaf the index of its tensor in that
    list or, for a leaf that is not a tensor, the leaf itself."""
    flat, spec = tree_flatten(tree)
    tensors, where, pattern = [], {}, []
    for x in flat:
        if isinstance(x, torch.Tensor):
            if id(x) not in where:
                where[id(x)] = len(tensors)
                tensors.append(x)
            pattern.append(where[id(x)])
        else:
            pattern.append(("const", x))
    return tensors, tuple(pattern), spec


def rebuild_tree(pattern, spec, tensors):
    """The pytree that _distinct_tensors took apart, over `tensors` in place of
    its distinct tensors."""
    return tree_unflatten([tensors[p] if isinstance(p, int) else p[1] for p in pattern], spec)


class GraphedTrip:
    """One trip of a differentiable loop as two CUDA graphs over static
    buffers: the counterpart of the JAX package's `lax.scan` over
    `jax.checkpoint(step)`, whose compiled body serves every trip.

    `step(state) -> state` maps a NamedTuple of tensors to another of the same
    shapes, and reads no tensor but its state and `step.leaves`, a pytree of
    the tensors it closes over (the scene tables, the packs built from them);
    `step.rebind(leaves)` builds the same step over other tensors of the same
    shapes, and `step.key` names what else the step depends on. A trip is
    built over static copies of the leaves and of one state:

    - G_f, the trip: under no_grad, the step from the static state to static
      outputs;
    - G_b, the trip's recompute and backward: the step again with the static
      state's floating fields and the leaves that require grad as autograd
      leaves, then `torch.autograd.grad` of the floating outputs against
      static cotangents.

    `run(step, state, trips)` copies the call's leaves into the static ones
    and runs `trips` trips, each an autograd Function: its forward copies the
    state in, replays G_f and returns clones of the outputs (the next trip
    overwrites them), saving only its input; its backward copies the saved
    input and the cotangents in, replays G_b and returns clones of the
    gradients, the leaves' among them, so autograd carries those on to
    whatever the caller built the leaves from. A backward reloads its call's
    leaves when another call has loaded its own since.

    The first trip of the first call runs the step eagerly with autograd on
    (on the card on a side stream), its values that trip's outputs, and a
    backward of it against zero cotangents: that builds the kernels and
    settles the allocator. Then, on the card, G_f and G_b are captured in one
    memory pool; a capture that fails raises. On the CPU, and for a step
    whose `capturable` is False, nothing is captured: the two bodies run
    where the replays would (`cuda` is False). `pool_bytes` is what the
    captures reserved; `per_replay` is [(counter, launches a replay runs)]
    for G_f and for G_b. `step_calls` counts the Python step's calls: one
    eagerly and one in each capture on the card, and none after. `replays`
    counts the replays of G_f and of G_b (on the CPU, the bodies run in
    their place); a caller reads it around a call, since autograd runs
    the backward's replays on a thread of its own, which a recording
    (utils/trace) does not reach. The two captures are one span
    `loop.capture`, after the wait for the queued work (`wait_for_device`),
    and count their `graph_pool_bytes`."""

    def __init__(self, step, state):
        tensors, self.pattern, self.spec = _distinct_tensors(step.leaves)
        self.diff_leaves = [i for i, t in enumerate(tensors) if t.requires_grad]
        self.leaves = [t.detach().clone() for t in tensors]
        for i in self.diff_leaves:
            self.leaves[i].requires_grad_()
        self.step = step.rebind(self._tree(self.leaves))
        self.make = type(state)
        self.state = self.make(*(x.detach().clone() for x in state))
        self.float_in = [i for i, x in enumerate(state) if x.is_floating_point()]
        # A step that is not capturable runs its bodies as on the CPU.
        self.cuda = captures(self.state[0].device) and getattr(step, "capturable", True)
        self.loaded = None
        self.diff_out = self.gout = self.out = self.gin = None
        self.graphs = ()
        self.pool_bytes = 0
        self.per_replay = ([], [])
        self.step_calls = 0
        self.replays = [0, 0]      # G_f, G_b

    @staticmethod
    def key(step, state):
        """What a trip's graphs depend on beyond the values of its inputs."""
        tensors, pattern, spec = _distinct_tensors(step.leaves)
        sig = lambda t: (tuple(t.shape), t.dtype, t.device, t.requires_grad)
        return (step.key, spec, pattern, tuple(map(sig, tensors)), tuple(map(sig, state)))

    def _tree(self, tensors):
        return rebuild_tree(self.pattern, self.spec, tensors)

    def _call_step(self, state):
        self.step_calls += 1
        return self.step(self.make(*state))

    def _forward_body(self):
        with torch.no_grad():
            return self._call_step(self.state)

    def _grad_inputs(self):
        """The step from the static state with its floating fields and the
        leaves that require grad as autograd leaves: (outputs, inputs)."""
        fl = set(self.float_in)
        x = [s.detach().requires_grad_() if i in fl else s for i, s in enumerate(self.state)]
        out = self._call_step(x)
        return out, [x[i] for i in self.float_in] + [self.leaves[j] for j in self.diff_leaves]

    def _backward_body(self):
        with torch.enable_grad():
            out, ins = self._grad_inputs()
            if not self.diff_out:
                return [None] * len(ins)
            return list(torch.autograd.grad([out[i] for i in self.diff_out], ins, self.gout,
                                            allow_unused=True))

    def _warm(self):
        """The first trip, eagerly with autograd on, and a backward of it
        against zero cotangents; returns the trip's outputs, detached (its
        autograd graph is gone before a capture starts)."""
        with torch.enable_grad():
            out, ins = self._grad_inputs()
            self.diff_out = [i for i, o in enumerate(out) if o.requires_grad]
            self.gout = [torch.zeros_like(out[i]) for i in self.diff_out]
            if self.diff_out:
                torch.autograd.grad([out[i] for i in self.diff_out], ins, self.gout,
                                    allow_unused=True)
            return [o.detach().clone() for o in out]

    def _prepare(self):
        """The warm-up trip (on the card on a side stream), then, on the
        card, the two captures. Returns the first trip's outputs."""
        if not self.cuda:
            first = self._warm()
            self.out = [o.clone() for o in first]
        else:
            side = torch.cuda.Stream(self.state[0].device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                first = self._warm()
            torch.cuda.current_stream().wait_stream(side)
            self._capture()
        return first

    def _capture(self):
        dev = self.state[0].device
        wait_for_device(dev)
        with trace.span("loop.capture"):
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            pool = torch.cuda.graph_pool_handle()
            g_f, g_b = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            counts = [c.captured for c in _COUNTERS]
            with torch.cuda.graph(g_f, pool=pool):
                self.out = self._forward_body()
            mid = [c.captured for c in _COUNTERS]
            with torch.cuda.graph(g_b, pool=pool):
                self.gin = self._backward_body()
            self.graphs = (g_f, g_b)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            self.per_replay = tuple(
                [(c, b - a) for c, a, b in zip(_COUNTERS, lo, hi) if b > a]
                for lo, hi in ((counts, mid), (mid, [c.captured for c in _COUNTERS])))
        trace.count("graph_pool_bytes", self.pool_bytes)

    def _replay(self, which):
        self.graphs[which].replay()
        for counter, n in self.per_replay[which]:
            counter.launches += n

    def replay_f(self):
        """G_f from the static state. On the CPU the step's body, its
        outputs copied into static buffers as a replay leaves them."""
        self.replays[0] += 1
        if self.cuda:
            self._replay(0)
        else:
            with torch.no_grad():
                copy_into(self.out, self._forward_body())

    def replay_b(self):
        """G_b from the static state and cotangents; on the CPU as replay_f."""
        self.replays[1] += 1
        if self.cuda:
            self._replay(1)
            return
        gin = self._backward_body()
        if self.gin is None:
            self.gin = [None if g is None else g.clone() for g in gin]
        else:
            with torch.no_grad():
                copy_into([g for g in self.gin if g is not None], [g for g in gin if g is not None])

    def load(self, call):
        """Copy a call's leaves into the static ones."""
        with torch.no_grad():
            for s, t in zip(self.leaves, call):
                s.copy_(t)
        self.loaded = call

    def forward(self, state):
        with torch.no_grad():
            copy_into(self.state, state)
        if self.out is None:
            return self._prepare()
        self.replay_f()
        return [o.clone() for o in self.out]

    def backward(self, call, state, gout):
        """(gradients of the state's fields, of the leaves that require grad)."""
        with torch.no_grad():
            if self.loaded is not call:
                self.load(call)
            copy_into(self.state, state)
            for buf, i in zip(self.gout, self.diff_out):
                if gout[i] is None:
                    buf.zero_()
                else:
                    buf.copy_(gout[i])
        self.replay_b()
        gin = [None if g is None else g.clone() for g in self.gin]
        g_state = [None] * len(self.state)
        for k, i in enumerate(self.float_in):
            g_state[i] = gin[k]
        return g_state, gin[len(self.float_in):]

    def run(self, step, state, trips: int):
        """`trips` trips of `step` (built like this trip's: same key) from
        `state`, each differentiable; returns the last state."""
        call = tuple(_distinct_tensors(step.leaves)[0])
        self.load(call)
        diff = [call[i] for i in self.diff_leaves]
        for _ in range(trips):
            state = self.make(*_Trip.apply(self, call, len(diff), *diff, *state))
        return state



class _Trip(torch.autograd.Function):
    """One trip of a GraphedTrip: inputs (the leaves that require grad, then
    the state's fields), outputs the next state's fields."""

    @staticmethod
    def forward(ctx, trip, call, n_leaves, *args):
        state = args[n_leaves:]
        out = trip.forward(state)
        ctx.trip, ctx.call = trip, call
        ctx.save_for_backward(*state)
        ctx.mark_non_differentiable(*(o for o in out if not o.is_floating_point()))
        return tuple(out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gout):
        g_state, g_leaves = ctx.trip.backward(ctx.call, ctx.saved_tensors, gout)
        return (None, None, None, *g_leaves, *g_state)
