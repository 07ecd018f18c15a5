"""CUDA graphs for the frozen conditioning networks.

A serving batch's conditioning is about 500 small launches (K2 at 288^2
and below, pools, bilinear resizes, cats), each with a Python path, so the
host sets its pace while the card waits.  A module enabled here replays
its forward from a CUDA graph instead: ``DewarpPipeline.create`` enables
Seg's U2NetP (``seg``), the text-line UNet (``line``) and GeoTrSegInf's
mask branch (``geotr``) of a pipeline built for serving.  Their ``forward``
calls :func:`call`; the glue around them stays eager.

:func:`call` runs ``fn(x)``:

- as it is, when the module is not enabled or a graph is being captured
  on this thread (a network inside another's capture);
- eagerly (mode ``eager``) for a CPU input or with autograd on, and for
  an input whose key has no graph yet;
- from a graph keyed by the input's shape, strides, dtype and device and
  the TF32 switches of cuBLAS and cuDNN (a replay does not see a switch
  turned after its capture): the first call of a key runs eagerly (it fills the
  fold caches and the resize matrices), the second captures it on a side
  stream (mode ``capture``: an eager pass on that stream, then the capture,
  then a replay), later calls replay it (mode ``replay``).  A module keeps
  at most ``MAX_KEYS`` graphs, sharing one memory pool; past that, its
  calls run eagerly.

Every tensor returned is fresh: the input is copied into the graph's
static input, and each output is cloned from the graph's static one
(callers keep outputs across batches).

A graph reads by address what its capture read: the K2 fold tensors
(``models/layers.py:fold_conv_bn``'s cache) and the resize matrices
(``ops/resize.py``'s cache) are held by the graph (:func:`hold`) for as
long as it lives, and the module's graphs (and their pool) are dropped
when any of its parameters or buffers is replaced, moved or loaded
(their ``data_ptr`` and ``_version``, the fold cache's condition;
``load_state_dict`` copies in place and bumps the versions), or when a
submodule is replaced.

Each call of an enabled module is recorded as a ``dvd.cond.graph`` span
(``utils/trace.py``; attributes ``net`` and ``mode``), nested in
``dvd.cond.<net>``; a replay's span also lists the kernel launches its
graph holds (attribute ``launches``, each as the kernel's wrapper noted
it at the capture, :func:`launched`).  The kernels' launch counters
(``conv3x3.launches``, ...) count launches made from Python: a capture
counts each launch twice (the side stream's pass and the capture), a
replay none.
"""

from __future__ import annotations

import contextlib
import itertools
import operator
import threading
from typing import Callable, Optional

import torch
import torch.nn as nn

from dvd_tpu_torch.utils import trace

MAX_KEYS = 4
SPAN = "dvd.cond.graph"
ATTR = "_cuda_graphs"

_local = threading.local()
_ptr = torch.Tensor.data_ptr
_version = operator.attrgetter("_version")


def hold(*objs) -> None:
    """Keep ``objs`` alive for as long as the graph being captured on this
    thread lives (a no-op when none is)."""
    held = getattr(_local, "held", None)
    if held is not None:
        held.extend(objs)


def launched(kernel: str, *sizes) -> None:
    """Note a launch of ``kernel`` with ``sizes`` in the graph being
    captured on this thread (a no-op when none is)."""
    launches = getattr(_local, "launches", None)
    if launches is not None:
        launches.append((kernel,) + sizes)


@contextlib.contextmanager
def holding():
    """While open, :func:`hold` keeps what it is given in the yielded
    list (a capture's), :func:`launched` notes launches in
    :func:`launches`, and :func:`capturing` is true on this thread."""
    held = _local.held = []
    _local.launches = []
    try:
        yield held
    finally:
        _local.held = _local.launches = None


def launches() -> tuple:
    """The launches noted so far in the capture open on this thread."""
    return tuple(getattr(_local, "launches", None) or ())


def capturing() -> bool:
    """True while this thread captures a graph of an enabled module."""
    return getattr(_local, "held", None) is not None


def input_key(x: torch.Tensor) -> tuple:
    """The key a graph of ``x`` is kept under."""
    return (tuple(x.shape), x.stride(), x.dtype, x.device,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _fresh(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_fresh(o) for o in out)
    return out


class _Graph:
    __slots__ = ("graph", "static_in", "static_out", "held", "launches")

    def __init__(self, graph, static_in, static_out, held, launches):
        self.graph, self.static_in = graph, static_in
        self.static_out, self.held = static_out, held
        self.launches = launches

    def replay(self, x: torch.Tensor):
        self.static_in.copy_(x)
        self.graph.replay()
        return _fresh(self.static_out)


class Graphs:
    """One enabled module's graphs, under its ``net`` name."""

    def __init__(self, net: str):
        self.net = net
        self.tree = None            # the module's submodules, in order
        self.children = None        # and their submodule dicts
        self.values = None          # their parameter and buffer dicts
        self.wkey = None
        self.warm: set = set()
        self.graphs: dict = {}
        self.pool = self.stream = None

    def __reduce__(self):
        # a copied or pickled module starts without graphs
        return Graphs, (self.net,)

    def weights_key(self, module: nn.Module) -> tuple:
        """(data_ptr..., _version...) of every parameter and buffer of the
        module's submodules, found anew when one of them is replaced."""
        if self.children is None or self.tree != tuple(
                itertools.chain.from_iterable(self.children)):
            mods = list(module.modules())
            self.children = [m._modules.values() for m in mods if m._modules]
            self.tree = tuple(itertools.chain.from_iterable(self.children))
            self.values = [d.values() for m in mods
                           for d in (m._parameters, m._buffers) if d]
        ts = [t for t in itertools.chain.from_iterable(self.values)
              if t is not None]
        return tuple(map(_ptr, ts)) + tuple(map(_version, ts))

    def refresh(self, module: nn.Module) -> None:
        """Drop the graphs, their memory pool and the keys warmed when the
        weights key has changed since the last call."""
        wkey = self.weights_key(module)
        if wkey != self.wkey:
            self.graphs.clear()
            self.warm.clear()
            self.pool = None        # a pool whose graphs are gone is not reused
            self.wkey = wkey

    def _eager(self, fn: Callable, x):
        with trace.span(SPAN, net=self.net, mode="eager"):
            return fn(x)

    def __call__(self, module: nn.Module, fn: Callable, x: torch.Tensor):
        if not x.is_cuda or torch.is_grad_enabled():
            return self._eager(fn, x)
        self.refresh(module)
        key = input_key(x)
        g = self.graphs.get(key)
        if g is not None:
            with trace.span(SPAN, net=self.net, mode="replay",
                            launches=g.launches):
                return g.replay(x)
        if len(self.graphs) >= MAX_KEYS:
            return self._eager(fn, x)
        if key not in self.warm:
            self.warm.add(key)
            return self._eager(fn, x)
        with trace.span(SPAN, net=self.net, mode="capture"):
            g = self.graphs[key] = self._capture(fn, x)
            self.warm.discard(key)
            return g.replay(x)

    def _capture(self, fn: Callable, x: torch.Tensor) -> _Graph:
        dev = x.device
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        with torch.inference_mode(False):
            static_in = torch.empty_like(x)
        static_in.copy_(x)
        # cuBLAS keeps a workspace per stream: make the side stream's
        # before the capture, outside the graph's pool
        cur = torch.cuda.current_stream(dev)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            fn(static_in)
        cur.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        with holding() as held, torch.cuda.graph(
                graph, pool=self.pool, stream=self.stream,
                capture_error_mode="thread_local"):
            out = fn(static_in)
            noted = launches()
        return _Graph(graph, static_in, out, held, noted)


def enable(module: nn.Module, net: str) -> None:
    """Replay ``module``'s forward from CUDA graphs, its calls' spans
    under ``net``."""
    module.__dict__[ATTR] = Graphs(net)


def disable(module: nn.Module) -> None:
    """Drop ``module``'s graphs: its forward runs eagerly, with no
    span."""
    module.__dict__.pop(ATTR, None)


def graphs_of(module: nn.Module) -> Optional[Graphs]:
    return module.__dict__.get(ATTR)


def call(module: nn.Module, fn: Callable, x: torch.Tensor):
    """``fn(x)`` for ``module``'s forward: from its graphs when it is
    enabled (see the module's docstring), else as it is."""
    g = module.__dict__.get(ATTR)
    if g is None or capturing():
        return fn(x)
    return g(module, fn, x)
