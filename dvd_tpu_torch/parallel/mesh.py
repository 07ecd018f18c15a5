"""Process mesh and sharding rules (port of ``dvd_tpu/parallel/mesh.py``)
on ``torch.distributed``.

``dvd_tpu`` lays a (data, model) ``jax.sharding.Mesh`` over its devices
and lets XLA insert the collectives.  Here one process drives one device,
the ranks form the same (data, model) grid, row-major (rank = d * model +
m), and the collectives are explicit (``parallel/comm.py``):

- ``data``: the global batch is split over the data index; a step's
  gradients are summed over the data group (the ranks with this rank's
  model index), and train-mode BatchNorm takes its moments over it;
- ``model``: tensor parallelism over attention heads and MLP hidden
  units, by the same rules as ``dvd_tpu`` (``_TP_RULES``, written for the
  port's parameter names, torch layout: a Linear's weight is (out, in)).
  A layer pair whose column half shards the output features and whose row
  half shards the input features needs one all-reduce; each rank holds
  whole heads (of a fused qkv: columns ``[r D/m, (r+1) D/m)`` of each of
  q, k and v), so the attention kernel runs on local heads;
- ``fsdp``: every other parameter whose largest axis divides over the data
  axis and spans at least two rows per rank is held, with its AdamW
  moments and EMA copies, as a shard of that axis (``dvd_tpu``'s
  largest-axis rule); it is all-gathered after each update, and its
  gradient is summed over the data group and sliced to the shard.

Without an initialised process group the mesh is 1 x 1 and has no
groups: every collective is then the identity.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from dvd_tpu_torch.parallel import comm

Spec = Tuple[Optional[str], ...]


def init_distributed(backend: str, device, *, rank: int, world_size: int,
                     init_method: str = "env://") -> torch.device:
    """Join the process group (``backend`` "nccl" on the card, "gloo" on
    the CPU or for several processes on one card) and make ``device`` this
    process's device; returns it."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of ranks, and this rank's data group (the ranks
    sharing its model index) and model group (those sharing its data
    index); None without a process group."""

    data: int
    model: int
    rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def primary(self) -> bool:
        return self.rank == 0


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """A (data, model) mesh over every rank of the process group (one
    rank without one); ``data=-1`` takes the ranks ``model`` leaves."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        assert n % model == 0, f"{n} devices not divisible by model={model}"
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    if not dist.is_initialized():
        return Mesh(data, model)
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in the same order
    for m in range(model):
        groups["data", m] = dist.new_group([d * model + m
                                            for d in range(data)])
    for d in range(data):
        groups["model", d] = dist.new_group([d * model + m
                                             for m in range(model)])
    return Mesh(data, model, rank, groups["data", rank % model],
                groups["model", rank // model])


def batch_slice(mesh: Optional[Mesh], n: int, chunks: int = 1,
                data_index: Optional[int] = None) -> torch.Tensor:
    """The global-batch rows that data index ``data_index`` (this rank's
    by default) holds as its ``n`` local rows, in local order: the
    counterpart of ``dvd_tpu``'s ``batch_sharding``.

    With ``chunks`` > 1 (microbatching) each rank's chunk i is its share of
    global chunk i: local row j is global row ``(j // c) * C + d * c + j %
    c`` for chunks of c local and C = c * data global rows.  Ranks in one
    model group hold the same rows."""
    data = mesh.data if mesh is not None else 1
    d = (mesh.data_index if mesh is not None else 0) if data_index is None \
        else data_index
    c = n // chunks
    j = torch.arange(n)
    return (j // c) * (c * data) + d * c + j % c


def gather_batch(local: torch.Tensor, mesh: Optional[Mesh],
                 chunks: int = 1) -> torch.Tensor:
    """The global-batch tensor from each data index's local rows
    (``batch_slice``'s layout), on every rank."""
    if mesh is None or mesh.data == 1:
        return local
    n = local.shape[0]
    parts = comm.all_gather(local, mesh.data_group)
    out = local.new_empty((n * mesh.data,) + tuple(local.shape[1:]))
    for d, part in enumerate(parts):
        out[batch_slice(mesh, n, chunks, d).to(out.device)] = part
    return out


# (regex over the port's parameter names) -> spec per torch dim.  First
# match wins.  dvd_tpu's rules, translated: its Dense kernels are (in, out)
# and P(None, "model") becomes ("model", None) on the (out, in) weight.
_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r"(.*\.)?attn\.qkv\.weight", ("model", None)),
    (r"(.*\.)?attn\.qkv\.bias", ("model",)),
    (r"(.*\.)?attn\.proj\.weight", (None, "model")),
    (r"(.*\.)?cross_attn.*\.(q_proj|k_proj|v_proj)\.weight", ("model", None)),
    (r"(.*\.)?cross_attn.*\.(q_proj|k_proj|v_proj)\.bias", ("model",)),
    (r"(.*\.)?cross_attn.*\.out_proj\.weight", (None, "model")),
    (r"(.*\.)?mlp\.fc1\.weight", ("model", None)),
    (r"(.*\.)?mlp\.fc1\.bias", ("model",)),
    (r"(.*\.)?mlp\.fc2\.weight", (None, "model")),
    (r"(.*\.)?decoder\..*\.(linear_q|linear_k|linear_v)\.weight",
     ("model", None)),
    (r"(.*\.)?decoder\..*\.attn\.fc\.weight", (None, "model")),
)


def tp_rule_spec(path: str) -> Optional[Spec]:
    """The raw ``_TP_RULES`` spec of a parameter name, or None (no
    divisibility fallback: a guard must see the intended spec)."""
    for pat, spec in _TP_RULES:
        if re.fullmatch(pat, path):
            return spec
    return None


def param_sharding_rules(path: str, shape: Tuple[int, ...], mesh: Mesh,
                         fsdp: bool = False) -> Spec:
    """The spec of one parameter: its TP rule where ``model`` > 1 and every
    sharded dim divides, else (``fsdp``) its largest axis over ``data``
    where that divides and is at least twice the data size, else
    replicated (``()``)."""
    if mesh.model > 1:
        spec = tp_rule_spec(path)
        if spec is not None and all(
                shape[i] % mesh.model == 0
                for i, name in enumerate(spec) if name == "model"):
            return spec
    if fsdp and shape:
        biggest = int(np.argmax(shape))
        if shape[biggest] % mesh.data == 0 \
                and shape[biggest] >= 2 * mesh.data:
            spec = [None] * len(shape)
            spec[biggest] = "data"
            return tuple(spec)
    return ()


@dataclasses.dataclass(frozen=True)
class Placement:
    """How one parameter is split: along ``axis`` into ``size`` shards over
    ``group`` (the mesh's ``kind`` axis: "model" for TP, "data" for FSDP),
    this rank holding shard ``index``; ``parts`` > 1 splits each of that
    many equal parts of the axis on its own (a fused qkv's q, k, v)."""

    kind: str
    axis: int
    size: int
    index: int
    group: Any
    parts: int = 1

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        pieces = full.chunk(self.parts, self.axis)
        return torch.cat([p.chunk(self.size, self.axis)[self.index]
                          for p in pieces], self.axis).contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        shards = comm.all_gather(local, self.group)
        parts = zip(*(s.chunk(self.parts, self.axis) for s in shards))
        return torch.cat([torch.cat(p, self.axis) for p in parts], self.axis)


def _tp_owners():
    from dvd_tpu_torch.models import layers, satrn

    # owner class -> (column-parallel children, row-parallel child, heads)
    return {layers.SelfAttention: (("qkv",), "proj", "num_heads"),
            layers.CrossAttention: (("q_proj", "k_proj", "v_proj"),
                                    "out_proj", "num_heads"),
            layers.Mlp: (("fc1",), "fc2", None),
            satrn.SATRNAttention: (("linear_q", "linear_k", "linear_v"),
                                   "fc", "n_head")}


def shard_params(module: nn.Module, mesh: Mesh, fsdp: bool = False
                 ) -> Dict[str, Placement]:
    """Apply the rules to ``module`` in place and return the placement of
    each sharded parameter, by name (the others are replicated).

    - TP (``mesh.model`` > 1): each attention or MLP whose every weight
      and bias has its rule and divides, and whose heads divide over the
      model axis, takes :class:`~comm.ColumnParallelLinear` and
      :class:`~comm.RowParallelLinear` layers holding this rank's slices
      (the parameter names stay) and its local head count.  A module that
      does not qualify stays whole.
    - FSDP: the placements of the other parameters that the largest-axis
      rule shards; the module keeps them whole (the train state holds the
      shards, ``ShardedParams``).
    - Every BatchNorm takes its train-mode moments over the data group.
    """
    from dvd_tpu_torch.models.layers import BatchNorm

    if getattr(module, "moe_spec", None) is not None:
        raise NotImplementedError(
            "a DiT with routed experts (models/moe.py) sharded by "
            "parallel.model_axis > 1 or parallel.fsdp is not ported")
    if getattr(module, "quant", False) and mesh.model > 1:
        raise NotImplementedError("int8 (model.quantize='int8') under "
                                  "tensor parallelism (parallel.model_axis"
                                  " > 1) is not ported")
    placements: Dict[str, Placement] = {}
    owners = _tp_owners()
    m = mesh.model
    for prefix, mod in list(module.named_modules()):
        if isinstance(mod, BatchNorm):
            mod.group = mesh.data_group
        spec = owners.get(type(mod))
        if m == 1 or spec is None:
            continue
        cols, row, heads = spec
        base = f"{prefix}." if prefix else ""
        leaves = {f"{base}{c}.{leaf}": p for c in cols + (row,)
                  for leaf, p in getattr(mod, c).named_parameters()}
        specs = {k: param_sharding_rules(k, tuple(p.shape), mesh)
                 for k, p in leaves.items()}
        row_bias = f"{base}{row}.bias"
        if any(tp_rule_spec(k) is None or "model" not in s
               for k, s in specs.items() if k != row_bias):
            continue
        if heads is not None and getattr(mod, heads) % m:
            continue
        g, i = mesh.model_group, mesh.model_index
        for c in cols:
            lin = getattr(mod, c)
            pl = Placement("model", 0, m, i, g, 3 if c == "qkv" else 1)
            setattr(mod, c, comm.parallel_linear(
                comm.ColumnParallelLinear, lin, pl.shard(lin.weight.detach()),
                None if lin.bias is None else pl.shard(lin.bias.detach()), g))
            placements[f"{base}{c}.weight"] = pl
            if lin.bias is not None:
                placements[f"{base}{c}.bias"] = pl
        lin = getattr(mod, row)
        pl = Placement("model", 1, m, i, g)
        setattr(mod, row, comm.parallel_linear(
            comm.RowParallelLinear, lin, pl.shard(lin.weight.detach()),
            None if lin.bias is None else lin.bias.detach().clone(), g))
        placements[f"{base}{row}.weight"] = pl
        if heads is not None:
            setattr(mod, heads, getattr(mod, heads) // m)
    if fsdp:
        for name, p in module.named_parameters():
            if name in placements:
                continue
            spec = param_sharding_rules(name, tuple(p.shape),
                                        dataclasses.replace(mesh, model=1),
                                        fsdp=True)
            if "data" in spec:
                placements[name] = Placement("data", spec.index("data"),
                                             mesh.data,
                                             mesh.data_index,
                                             mesh.data_group)
    return placements


class ShardedParams:
    """The train state's parameters under a mesh: for each parameter (in
    ``named_parameters`` order) the tensor the optimizer and the EMA hold
    (``held``): the module's own parameter, or for FSDP a shard of it.

    ``reduce_grads`` sums the module parameters' gradients over the data
    group and slices the FSDP ones to their shards; ``gather_`` writes the
    updated shards back into the module; ``norm`` is the global gradient
    norm (shard squares summed over their groups); ``unsharded`` gathers a
    held tensor (or one of its moments) to the full layout."""

    def __init__(self, module: nn.Module, mesh: Mesh,
                 placements: Dict[str, Placement]):
        self.mesh = mesh
        self.placements = placements
        self.module_params = dict(module.named_parameters())
        # in parameter order: every rank gathers in the same order
        self.fsdp = tuple(n for n in self.module_params
                          if n in placements
                          and placements[n].kind == "data")
        self.held: Dict[str, torch.Tensor] = {}
        for n, p in self.module_params.items():
            self.held[n] = nn.Parameter(placements[n].shard(p.detach()),
                                        requires_grad=p.requires_grad) \
                if n in self.fsdp else p

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        comm.all_reduce_bucketed(grads, self.mesh.data_group)
        return [self.placements[n].shard(g) if n in self.fsdp else g
                for n, g in zip(self.module_params, grads)]

    @torch.no_grad()
    def gather_(self) -> None:
        for n in self.fsdp:
            self.module_params[n].copy_(
                self.placements[n].gather(self.held[n]))

    def norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        from dvd_tpu_torch.training.train_state import global_norm

        names = list(self.module_params)
        whole = [g for n, g in zip(names, grads) if n not in self.placements]
        if len(whole) == len(grads):
            return global_norm(grads)
        sq = global_norm(whole) ** 2 if whole else grads[0].new_zeros(())
        for kind, group in (("model", self.mesh.model_group),
                            ("data", self.mesh.data_group)):
            part = [g for n, g in zip(names, grads)
                    if n in self.placements
                    and self.placements[n].kind == kind]
            if part:
                sq = sq + comm.all_reduce_(global_norm(part) ** 2, group)
        return torch.sqrt(sq)

    def unsharded(self, name: str, t: torch.Tensor) -> torch.Tensor:
        pl = self.placements.get(name)
        return t if pl is None else pl.gather(t)
