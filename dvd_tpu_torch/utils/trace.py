"""The port's spans: named stretches of the program's own work, stamped on
the clock of ``torch.profiler``'s host events.

``span(name, **attrs)`` is a context manager.  It records only while
tracing is active: while a ``torch.profiler`` records (the profiler's
flag reads true in every thread), or between :func:`enable` and
:func:`disable`.  Otherwise it returns one shared
``contextlib.nullcontext()`` after a flag check, with no torch call.

A record is ``(name, t0_ns, t1_ns, thread, parent, attrs)``:

- ``t0_ns``, ``t1_ns``: ``time.time_ns()`` stamps, Unix-epoch
  nanoseconds, the clock of the profiler's host events, through which a
  span lines up with the device activities of the same trace (``t1_ns``
  is None while the span is open);
- ``thread``: ``threading.get_ident()`` of the thread that opened it;
- ``parent``: the index in :func:`records` of the enclosing span on the
  same thread, or None;
- ``attrs``: what the program knows there (``pages``, ``batch``,
  ``step``, ``bytes``).

The buffer keeps at most ``CAPACITY`` records; a span that finds it full
is not recorded and is counted in :func:`dropped`.

The spans are not ``record_function`` ranges: on a card the profiler
mirrors each such range that launches device work onto the device's
timeline, where it would read as device activity.

The program's spans (``dvd.<layer>[.<part>]``):

- ``dvd.cond`` (``DewarpPipeline.build_conditioning``) and inside it
  ``dvd.cond.geotr``, ``dvd.cond.seg``, ``dvd.cond.line``,
  ``dvd.cond.vgg``, those that run, and in the first three one
  ``dvd.cond.graph`` per call of a network that replays CUDA graphs
  (``utils/graphs.py``; attributes ``net`` and ``mode``: ``eager``,
  ``capture`` or ``replay``, and on a replay ``launches``, the kernel
  launches its graph holds);
- ``dvd.sample`` (``DewarpPipeline.sampling_impl``) and inside it one
  ``dvd.sample.step`` per DDIM step (``diffusion/sampler.py``), and in
  each step the DiT's ``dvd.dit.blocks`` (the blocks that run; attributes
  ``blocks``, ``streams``, ``tokens``) and, in its 'para' mode,
  ``dvd.dit.decoder`` (the SATRN decoder and the final layer; ``width``)
  (``models/dit.py``);
- ``dvd.unwarp`` (``ops/kernels/unwarp.py``: ``unwarp_fixed``,
  ``unwarp_native``, the dataset driver's ``unwarp_u8``);
- the dataset driver (``evaluation/driver.py``): ``dvd.driver.wait``
  (the next batch from the loader thread), ``dvd.driver.h2d`` (the
  batch's inputs onto the device), ``dvd.driver.drain`` (a batch's
  results back to the host, its writes queued), ``dvd.driver.write`` (one
  file, in a writer thread) and ``dvd.loader.batch`` (one batch made, in
  the loader thread);
- training (``training/train_loop.py``, ``train_state.py``,
  ``diffusion/losses.py``): per step ``dvd.train.prep`` (the batch's
  preparation, the augmentation and the frozen conditioning included),
  ``dvd.train.loss_backward`` (the loss and its gradients; in the
  time-variant loss ``dvd.train.rollout`` inside it, the rollout without
  gradient) and ``dvd.train.optimizer_ema`` (the optimizer's step and the
  EMA update).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional, Tuple

import torch.autograd.profiler as _profiler

CAPACITY = 1 << 18
Record = Tuple[str, int, Optional[int], int, Optional[int], dict]
_NULL = contextlib.nullcontext()


class Tracer:
    """An in-memory span buffer (the process has one, behind the module's
    functions)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.on = False
        self.buf: List[Record] = []
        self.dropped = 0
        self.gen = 0        # bumped by clear(): open spans lose their slot
        self.lock = threading.Lock()
        self.local = threading.local()

    def span(self, name: str, **attrs):
        """A span named ``name`` with ``attrs`` while tracing is active,
        else the shared no-op context."""
        if not (self.on or _profiler._is_profiler_enabled):
            return _NULL
        return _Span(self, name, attrs)

    def records(self) -> List[Record]:
        """A copy of the buffer: every thread's records, in the order the
        spans opened."""
        with self.lock:
            return list(self.buf)

    def clear(self) -> None:
        """Empty the buffer and the dropped count."""
        with self.lock:
            self.buf = []
            self.dropped = 0
            self.gen += 1


class _Span:
    __slots__ = ("tr", "name", "attrs", "gen", "i")

    def __init__(self, tr: Tracer, name: str, attrs: dict):
        self.tr, self.name, self.attrs = tr, name, attrs
        self.i = -1

    def __enter__(self):
        tr = self.tr
        stack = getattr(tr.local, "stack", None)
        if stack is None:
            stack = tr.local.stack = []     # (gen, index) of open spans
        with tr.lock:
            if len(tr.buf) >= tr.capacity:
                tr.dropped += 1
                return self
            parent = stack[-1][1] if stack and stack[-1][0] == tr.gen \
                else None
            self.gen, self.i = tr.gen, len(tr.buf)
            tr.buf.append((self.name, time.time_ns(), None,
                           threading.get_ident(), parent, self.attrs))
        stack.append((self.gen, self.i))
        return self

    def __exit__(self, *exc) -> bool:
        if self.i < 0:
            return False
        t1 = time.time_ns()
        tr = self.tr
        tr.local.stack.pop()
        with tr.lock:
            if tr.gen == self.gen:
                name, t0, _, thread, parent, attrs = tr.buf[self.i]
                tr.buf[self.i] = (name, t0, t1, thread, parent, attrs)
        return False


TRACER = Tracer()
span = TRACER.span
records = TRACER.records
clear = TRACER.clear


def enable() -> None:
    """Record spans without a profiler, until :func:`disable`."""
    TRACER.on = True


def disable() -> None:
    TRACER.on = False


def dropped() -> int:
    """Spans not recorded because the buffer was full."""
    return TRACER.dropped
