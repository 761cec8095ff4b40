"""Compiled programs: the port's counterpart of `jax.jit`.

The JAX package compiles every device program on its host paths with
`jax.jit`, once per signature.  `compiled(fn, static=(...))` does the same
for a function of tensors on a CUDA device: the first call with a new
signature captures `fn` into a `torch.cuda.CUDAGraph`, and every later call
with that signature copies its inputs into the graph's static input buffers
and replays it.

- **The key**: the values of the `static` arguments; the structure of the
  other arguments (NamedTuples, tuples, lists and dicts are walked); the
  shape, dtype, device and strides of every tensor leaf; the value of every
  other leaf.  A capture bakes the Python numbers it reads into the graph,
  so they key the entry (the port's `VehicleParams` holds floats where JAX
  traces them as array leaves).  The strides key it too, so that the body
  reads its static buffers in the layout the eager call would read.
- **First call on CUDA**: the body is captured on a memory pool that all
  entries share (`_Graph`, below) and replayed.  A body that waits for the
  host, copies host → device or reads a tensor's value into Python fails its
  capture, and the error propagates: nothing falls back to eager.
- **Outputs belong to the caller**, as JAX's do: after each replay the
  static outputs are copied out, one `torch.cat` per dtype, into fresh
  tensors; no later call overwrites them.
- **Nesting**: inside another capture or another compiled body the callable
  runs `fn` itself, as a jitted function called in a traced program is
  inlined.  Under `disable_compiled()` (`jax.disable_jit`) every compiled
  callable runs `fn` eagerly and makes no entry.
- **On the CPU** the same keys, static buffers, copies and output clones
  are used; the "replay" is `fn` run over the static buffers.
- **Tracing** (`utils.tracing`): an outermost call is the span
  `frenetix.compiled`, with the children `.key` (bind, flatten, key
  lookup), `.copy_in`, `.replay` (the replay and the counters' record) and
  `.own`; a capture made with tracing on keeps the device spans and device
  counters of its body as nodes of the graph (`tracing.capture()`).  An
  entry captured under the other tracing state is dropped at its next call
  and captured again.

`_Graph` is the port's one way to capture, replay and count a CUDA graph;
the compiled entries and the device-resident run's cycle
(`parallel.device_sim`) both use it.  It warms the body up once on a side
stream under `tracing.warming()` (this builds the kernels and warms the
allocator), captures it, and records what the capture added to every host
counter of `utils.tracing` (the kernels' launch counters among them); each
replay adds that record, so a replayed body counts what its eager twin
counts.  The warm-up's counts are set-up and are not counted, nor are the
capture's (it records, it does not launch).  A graph is `stale` once
tracing was switched since its capture, and is then never replayed.

`CAPTURES` counts the entries made (graphs captured on the card); each
compiled callable keeps its `entries`, `captures` and `capture_s`, and
`stats()` lists them.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import threading
import time
import weakref

import torch

from frenetix_tpu_torch.utils import tracing

__all__ = ["CAPTURES", "Compiled", "compiled", "disable_compiled", "clear_all",
           "stats"]

# entries made by all compiled callables (CUDA graphs captured on the card)
CAPTURES = 0
# entries a compiled callable keeps; the least recently used goes first
MAX_ENTRIES = 64

_LOCAL = threading.local()
_REGISTRY: "weakref.WeakSet[Compiled]" = weakref.WeakSet()
# device → (the graph pool its entries share, the graphs captured into it)
_POOLS: dict = {}


def _depth() -> int:
    return getattr(_LOCAL, "depth", 0)


@contextlib.contextmanager
def _inside():
    _LOCAL.depth = _depth() + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1


@contextlib.contextmanager
def disable_compiled():
    """Every compiled callable runs its body eagerly in this block and makes
    no entry: the counterpart of `jax.disable_jit`."""
    saved = getattr(_LOCAL, "disabled", False)
    _LOCAL.disabled = True
    try:
        yield
    finally:
        _LOCAL.disabled = saved


# ------------------------------------------------------------------ trees
_TENSOR = "T"


def _flatten(x, leaves: list):
    """The structure of `x` with its tensors appended to `leaves`: a
    hashable tree whose non-tensor leaves carry their values."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _TENSOR
    if isinstance(x, tuple):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, list):
        return (list, tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        keys = tuple(x)
        return (dict, keys, tuple(_flatten(x[k], leaves) for k in keys))
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"compiled: an argument leaf of type {type(x).__name__} is "
                        "neither a tensor nor hashable") from None
    # a float keys by its bits (0.0 and -0.0 bake different graphs, and a
    # NaN equals itself there)
    return ("leaf", type(x), x.hex() if isinstance(x, float) else x)


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(node):
        if node is _TENSOR:
            return next(it)
        if node[0] == "leaf":
            _, cls, value = node
            return cls(float.fromhex(value)) if issubclass(cls, float) else value
        if node[0] is dict:
            return {k: build(v) for k, v in zip(node[1], node[2])}
        cls, children = node
        values = [build(c) for c in children]
        if cls is list:
            return values
        if hasattr(cls, "_fields"):
            return cls(*values)
        return cls(values)

    return build(tree)


def _spec(t: torch.Tensor):
    return (tuple(t.shape), t.dtype, t.device, t.stride())


def _dense(t: torch.Tensor) -> torch.Tensor:
    """`t` without the repeats of its broadcast (stride-0) axes: the part a
    copy has to write."""
    for dim, (size, stride) in enumerate(zip(t.shape, t.stride())):
        if stride == 0 and size > 1:
            t = t.narrow(dim, 0, 1)
    return t


def _buffer(t: torch.Tensor) -> torch.Tensor:
    """A static buffer in `t`'s layout (a broadcast axis stays broadcast)."""
    buf = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
    _dense(buf).copy_(_dense(t))
    return buf


def _copy_in(buffers, leaves) -> None:
    for buf, t in zip(buffers, leaves):
        if t is not buf:
            _dense(buf).copy_(_dense(t))


def _own(tree, outs):
    """Fresh tensors holding the values of `outs`: one `torch.cat` per
    (device, dtype), split into views of the new buffer."""
    groups = collections.defaultdict(list)
    for i, t in enumerate(outs):
        groups[(t.device, t.dtype)].append(i)
    fresh = [None] * len(outs)
    for idx in groups.values():
        flat = torch.cat([outs[i].reshape(-1) for i in idx])
        parts = flat.split([outs[i].numel() for i in idx])
        for i, part in zip(idx, parts):
            fresh[i] = part.view(outs[i].shape)
    return _unflatten(tree, fresh)


def _pool(device: torch.device):
    """(handle, graphs) of the pool that captures on `device` share.  When
    every graph captured into a pool is gone the allocator retires the pool
    (a capture into it would fail), so a new one is taken then."""
    handle, graphs = _POOLS.get(device, (None, None))
    if not graphs:
        handle, graphs = torch.cuda.graph_pool_handle(), weakref.WeakSet()
        _POOLS[device] = (handle, graphs)
    return handle, graphs


class _Graph:
    """`body()` captured into a CUDA graph on `device` and the graph pool
    `pool` (None: a pool of its own), after one warm-up pass on a side
    stream (see the module's doc).  `out` is what the captured call
    returned, `counts` what it added to each host counter."""

    __slots__ = ("graph", "out", "counts", "traced", "__weakref__")

    def __init__(self, body, device: torch.device, pool=None):
        before = dict(tracing.COUNTERS)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(stream)
            with torch.cuda.stream(side), tracing.warming():
                body()
            stream.wait_stream(side)
            at_capture = dict(tracing.COUNTERS)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = body()
        after = dict(tracing.COUNTERS)
        self.counts = {k: n - at_capture.get(k, 0) for k, n in after.items()
                       if n != at_capture.get(k, 0)}
        for k, n in after.items():
            tracing.count(k, before.get(k, 0) - n)
        self.traced = tracing.enabled()

    @property
    def stale(self) -> bool:
        """Tracing was switched since the capture."""
        return self.traced != tracing.enabled()

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.counts.items():
            tracing.count(k, n)


class _Entry:
    __slots__ = ("buffers", "graph", "out_tree", "outs", "spans", "__weakref__")

    def __init__(self, buffers):
        self.buffers = buffers
        self.graph = None       # the _Graph, on the card
        self.out_tree = None
        self.outs = None
        self.spans = None       # tracing.DeviceSpans of the capture, if any


class Compiled:
    """A compiled callable with `fn`'s signature (see the module's doc).
    `eager` is the body itself; `entries` the cache, keyed by signature."""

    def __init__(self, fn, static=()):
        self.eager = fn
        self.static = tuple(static)
        self._signature = inspect.signature(fn)
        missing = [s for s in self.static if s not in self._signature.parameters]
        if missing:
            raise ValueError(f"compiled({fn.__qualname__}): no parameters {missing}")
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.captures = 0
        self.capture_s = 0.0
        functools.update_wrapper(self, fn)
        _REGISTRY.add(self)

    def __repr__(self):
        return f"<compiled {self.__qualname__}: {len(self.entries)} entries>"

    def clear(self) -> None:
        self.entries.clear()

    def __call__(self, *args, **kwargs):
        if getattr(_LOCAL, "disabled", False) or _depth() > 0:
            return self.eager(*args, **kwargs)
        with tracing.span("frenetix.compiled"):
            with tracing.span("frenetix.compiled.key"):
                bound, tree, leaves, key = self._key(args, kwargs)
                entry = self.entries.get(key) if leaves else None
            if not leaves:
                return self.eager(*args, **kwargs)
            cuda = leaves[0].device.type == "cuda"
            if cuda and torch.cuda.is_current_stream_capturing():
                return self.eager(*args, **kwargs)     # inlined into the outer capture
            if entry is not None and entry.graph is not None and entry.graph.stale:
                # dropped before the new capture: the two never hold memory at once
                del self.entries[key]
                entry = None
            if entry is None:
                entry = self._make(tree, leaves, bound, cuda)
                self.entries[key] = entry
                while len(self.entries) > MAX_ENTRIES:
                    self.entries.popitem(last=False)
            else:
                self.entries.move_to_end(key)
            return self._run(entry, tree, leaves, bound, cuda)

    def _key(self, args, kwargs):
        """(bound arguments, tree, tensor leaves, key) of a call."""
        bound = self._signature.bind(*args, **kwargs)
        bound.apply_defaults()
        statics, dynamic = [], {}
        for name, value in bound.arguments.items():
            if name in self.static:
                held: list = []
                statics.append((name, _flatten(value, held)))
                if held:
                    raise TypeError(f"{self.__qualname__}: the static argument "
                                    f"{name!r} holds a tensor")
            else:
                dynamic[name] = value
        leaves: list = []
        tree = _flatten(dynamic, leaves)
        if leaves and any(t.device != leaves[0].device for t in leaves):
            raise ValueError(f"{self.__qualname__}: compiled arguments lie on "
                             f"{sorted({str(t.device) for t in leaves})}; one device only")
        return bound, tree, leaves, (tuple(statics), tree, tuple(_spec(t) for t in leaves))

    def _call_body(self, bound, tree, buffers):
        """The body on the static buffers in place of the tensor leaves."""
        arguments = dict(bound.arguments)
        arguments.update(_unflatten(tree, buffers))
        call = inspect.BoundArguments(self._signature, arguments)
        with _inside():
            return self.eager(*call.args, **call.kwargs)

    def _make(self, tree, leaves, bound, cuda) -> _Entry:
        global CAPTURES
        t0 = time.perf_counter()
        entry = _Entry([_buffer(t) for t in leaves])
        if cuda:
            device = leaves[0].device
            pool, pool_graphs = _pool(device)
            with tracing.capture() as spans:
                entry.graph = _Graph(lambda: self._call_body(bound, tree, entry.buffers),
                                     device, pool)
            pool_graphs.add(entry.graph)
            entry.spans = tracing.DeviceSpans(spans) if spans else None
            outs: list = []
            entry.out_tree = _flatten(entry.graph.out, outs)
            entry.outs = outs
        CAPTURES += 1
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return entry

    def _run(self, entry: _Entry, tree, leaves, bound, cuda):
        with tracing.span("frenetix.compiled.copy_in"):
            _copy_in(entry.buffers, leaves)
        if not cuda:
            with tracing.span("frenetix.compiled.replay"):
                outs: list = []
                out_tree = _flatten(self._call_body(bound, tree, entry.buffers), outs)
            with tracing.span("frenetix.compiled.own"):
                return _own(out_tree, outs)
        with torch.cuda.device(leaves[0].device):
            with tracing.span("frenetix.compiled.replay"):
                if entry.spans is not None:
                    entry.spans.fold()
                entry.graph.replay()
                if entry.spans is not None:
                    entry.spans.replayed()
            with tracing.span("frenetix.compiled.own"):
                return _own(entry.out_tree, entry.outs)


def compiled(fn=None, *, static=()):
    """`fn` compiled per signature, with `static` naming the arguments whose
    values key the entry (`jax.jit`'s `static_argnames`).  Usable as
    `compiled(fn, static=...)` or as a decorator `@compiled(static=...)`."""
    if fn is None:
        return functools.partial(compiled, static=static)
    return Compiled(fn, static)


def clear_all() -> None:
    """Drop every entry of every compiled callable."""
    for c in list(_REGISTRY):
        c.clear()


def stats() -> dict:
    """qualified name → (entries, captures, capture seconds) of every
    compiled callable that has made an entry."""
    out = {}
    for c in _REGISTRY:
        if c.captures:
            name = f"{c.__module__}.{c.__qualname__}"
            n, k, s = out.get(name, (0, 0, 0.0))
            out[name] = (n + len(c.entries), k + c.captures, s + c.capture_s)
    return out
