"""Collectives of the parallel layer, and random draws for a global batch.

Every function takes a ``torch.distributed`` process group, or None for
one process without a group, where it is the identity.  They use only
the collectives that gloo and NCCL both have (``all_reduce``,
``all_gather``), so the same code runs on the CPU under gloo and on the
card under NCCL.

- ``copy_to_group`` and ``reduce_from_group`` are Megatron's pair around
  a column- and row-parallel layer: identity forward with an all-reduce
  of the gradient, and all-reduce forward with an identity backward;
  :class:`ColumnParallelLinear` and :class:`RowParallelLinear` use them.
- ``all_reduce_sum`` all-reduces forward and backward (train-mode
  BatchNorm's moments over the data group).
- ``all_reduce_bucketed`` sums a list of tensors in place, a few large
  flat buffers at a time (the gradients of a step).

Random draws follow the global batch: inside ``batch_rows(rows, total)``
:func:`randn` and :func:`rand` draw a tensor for all ``total`` rows of the
global batch and keep this process's ``rows``, so every process draws from
the same generator what one process holding the global batch would draw,
and each keeps its own part.  A leading axis of ``g * len(rows)`` is ``g``
blocks of the batch (the sampler's hypotheses, block-major), each sliced
alike.  Outside the context they are ``torch.randn`` and ``torch.rand``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceSum.apply(x, group)


def all_reduce_bucketed(tensors: Sequence[torch.Tensor], group,
                        bucket_bytes: int = 32 << 20) -> None:
    """Sum every tensor over ``group`` in place: tensors of one dtype and
    device are flattened into buffers of up to ``bucket_bytes``, one
    all-reduce each."""
    if group is None:
        return
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if bucket:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            for t, part in zip(bucket, flat.split([t.numel()
                                                   for t in bucket])):
                t.copy_(part.view_as(t))
        bucket, size = [], 0

    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device
                       or size + t.numel() * t.element_size() > bucket_bytes):
            flush()
        bucket.append(t)
        size += t.numel() * t.element_size()
    flush()


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape on each), by rank in the group."""
    if group is None:
        return [t]
    out = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


class ColumnParallelLinear(nn.Linear):
    """A linear layer holding a slice of the output features (and of the
    bias): ``copy_to_group`` on its input, no collective on its output."""

    group = None

    def forward(self, x):
        return F.linear(copy_to_group(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Linear):
    """A linear layer holding a slice of the input features: its partial
    product is summed over the group (``reduce_from_group``), then the
    whole bias added."""

    group = None

    def forward(self, x):
        y = reduce_from_group(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def parallel_linear(cls, like: nn.Linear, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], group) -> nn.Linear:
    """A ``cls`` layer (Column/RowParallelLinear) in place of ``like``,
    holding the local ``weight`` (out, in) and ``bias`` as parameters that
    require gradients as ``like``'s do."""
    layer = cls(weight.shape[1], weight.shape[0], bias=bias is not None,
                device="meta")
    grad = like.weight.requires_grad
    layer.weight = nn.Parameter(weight, requires_grad=grad)
    if bias is not None:
        layer.bias = nn.Parameter(bias, requires_grad=grad)
    layer.group = group
    return layer


# ------------------------------------------------------------------ draws
_ROWS: contextvars.ContextVar = contextvars.ContextVar("dvd_batch_rows",
                                                     default=None)


@contextlib.contextmanager
def batch_rows(rows: torch.Tensor, total: int):
    """While open, :func:`randn` and :func:`rand` draw for a global batch
    of ``total`` rows and keep ``rows`` (this process's, in its order).
    All the rows in order: the plain draws."""
    rows = rows.long().cpu()
    whole = torch.equal(rows, torch.arange(total))
    token = _ROWS.set(None if whole else (rows, int(total)))
    try:
        yield
    finally:
        _ROWS.reset(token)


def _draw(fn, shape, generator, device, dtype) -> torch.Tensor:
    shape = tuple(shape)
    held = _ROWS.get()
    if held is None:
        return fn(shape, generator=generator, device=device, dtype=dtype)
    rows, total = held
    blocks, rem = divmod(shape[0], len(rows))
    if rem:
        raise ValueError(f"a draw of {shape} on {len(rows)} rows of a batch "
                         f"of {total}")
    full = fn((blocks * total,) + shape[1:], generator=generator,
              device=device, dtype=dtype)
    idx = (torch.arange(blocks)[:, None] * total + rows[None]).reshape(-1)
    return full.index_select(0, idx.to(full.device))


def randn(shape, *, generator: Optional[torch.Generator], device=None,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _draw(torch.randn, shape, generator, device, dtype)


def rand(shape, *, generator: Optional[torch.Generator], device=None,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _draw(torch.rand, shape, generator, device, dtype)
