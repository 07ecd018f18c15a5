"""Weight conversion, numpy and torch only (no JAX, flax or ``dvd_tpu``).

Two directions:

1. **The reference's torch checkpoints -> flax variable trees**, the
   port's own copy of ``dvd_tpu/training/convert.py``
   (``load_torch_state_dict``, ``convert_state_dict`` and the rule sets
   ``DIT_RULES``, ``GEOTR_SEG_RULES``, ``U2NETP_RULES``,
   ``LINE_UNET_RULES``, ``VGG16_RULES``, ``unet_rules``,
   ``TRANSFORMER_RULES``): conv weights (O, I, kh, kw) ->
   (kh, kw, I, O), linear (O, I) -> (I, O), norm ``weight`` -> ``scale``,
   BN ``running_*`` -> the ``batch_stats`` collection, packed
   ``in_proj_*`` -> q/k/v projections, and regex module-path rewrites per
   model family.  The trees are what ``dvd_tpu``'s converter writes, so
   either package serves the same ``.msgpack`` files.
2. **Flax variables <-> the port's state_dicts.**  The port's module
   attributes follow the flax parameter paths, so the bridge is a name map
   plus two layout changes: a flax ``kernel`` becomes ``weight`` (Dense
   (in, out) -> (out, in), Conv HWIO -> OIHW); every other leaf keeps its
   name and value (``bias``, LayerNorm/BN ``scale``, and the BN statistics
   ``mean``/``var`` of the ``batch_stats`` collection).  Nothing is folded
   here; the aux nets fold BN into K2's epilogue at run time
   (``models/layers.py:fold_conv_bn``).  ``state_dict_to_variables`` is
   the inverse, for writing the port's weights as flax variable files.

Variables are nested dicts of numpy arrays or CPU tensors (``{"params":
..., "batch_stats": ...}``), as ``dvd_tpu``'s ``Module.init`` returns
after ``jax.device_get``, as the converter builds them, or as
``utils/msgpack_io`` reads them (bfloat16 leaves as tensors).

The alternative denoisers' rule sets are here too: ``unet_rules`` (after
``preprocess_unet_attention``) and ``TRANSFORMER_RULES``.
``dvd_tpu``'s ``split_frozen_bn`` is not copied: it is the identity (the
converter already writes FrozenBatchNorm's layout) and nothing calls it.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

class ConvertReport(NamedTuple):
    missing: List[str]      # state_dict keys the variables did not provide
    unexpected: List[str]   # converted keys the module does not have
    skipped: List[str]      # flax keys under the module's absent_subtrees


def as_tensor(leaf) -> torch.Tensor:
    """A variable leaf (tensor, numpy array, bfloat16 numpy array) as a CPU
    tensor of the same dtype."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def flatten_tree(tree: Mapping, sep: str = "/", prefix: str = ""
                 ) -> Dict[str, Any]:
    """A nested mapping's leaves under their ``sep``-joined paths."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, sep, p))
        else:
            out[p] = v
    return out


def flatten_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Merge the params and batch_stats collections into dotted paths."""
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        out.update((k, as_tensor(v)) for k, v in
                   flatten_tree(variables.get(coll, {}), ".").items())
    return out


def flax_leaf_to_torch(key: str, arr: torch.Tensor
                       ) -> Tuple[str, torch.Tensor]:
    path, _, leaf = key.rpartition(".")
    if leaf == "kernel":
        if arr.dim() == 2:
            arr = arr.t()
        elif arr.dim() == 4:
            arr = arr.permute(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {arr.dim()} at {key}")
        leaf = "weight"
    return (f"{path}.{leaf}" if path else leaf), arr.contiguous()


def variables_to_state_dict(variables: Mapping, module: nn.Module
                            ) -> Tuple[Dict[str, torch.Tensor], ConvertReport]:
    """Flax variables -> a state_dict for ``module`` (dtypes follow the
    module) and a report of missing, unexpected and skipped keys.  Keys
    under the module's ``absent_subtrees`` (the mask-only
    ``GeoTrSegInf``'s ``GeoTr.``) are skipped.  Shape mismatches raise."""
    skip = tuple(getattr(module, "absent_subtrees", ()))
    target = module.state_dict()
    sd: Dict[str, torch.Tensor] = {}
    unexpected, skipped = [], []
    for key, arr in sorted(flatten_variables(variables).items()):
        if key.startswith(skip):
            skipped.append(key)
            continue
        tkey, tarr = flax_leaf_to_torch(key, arr)
        if tkey not in target:
            unexpected.append(tkey)
            continue
        if target[tkey].shape != tarr.shape:
            raise ValueError(f"{tkey}: shape {tuple(tarr.shape)} vs module "
                             f"{tuple(target[tkey].shape)}")
        sd[tkey] = tarr.to(target[tkey].dtype)
    missing = sorted(set(target) - set(sd))
    return sd, ConvertReport(missing, unexpected, skipped)


def load_variables(module: nn.Module, variables: Mapping) -> ConvertReport:
    """Convert and load; raises unless every module key is provided and
    every converted key is used (deliberate skips are reported)."""
    sd, report = variables_to_state_dict(variables, module)
    if report.missing or report.unexpected:
        raise ValueError(f"weight bridge: missing {report.missing[:8]} "
                         f"unexpected {report.unexpected[:8]}")
    module.load_state_dict(sd)
    return report


# batch_stats leaves: the BN running statistics
STATS_LEAVES = ("mean", "var")


def state_dict_to_variables(state_dict: Mapping[str, torch.Tensor]
                            ) -> Dict[str, Dict[str, Any]]:
    """The inverse of :func:`variables_to_state_dict`: a port module's
    state_dict -> flax variables ``{"params", "batch_stats"}`` of detached
    CPU tensors in the state_dict's dtypes (``weight`` -> ``kernel``
    transposed back, BN ``mean``/``var`` into ``batch_stats``)."""
    variables: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, val in state_dict.items():
        val = val.detach().cpu()
        path, _, leaf = key.rpartition(".")
        if leaf == "weight":
            if val.dim() == 2:
                val = val.t()
            elif val.dim() == 4:
                val = val.permute(2, 3, 1, 0)
            else:
                raise ValueError(f"weight of rank {val.dim()} at {key}")
            leaf = "kernel"
        coll = "batch_stats" if leaf in STATS_LEAVES else "params"
        _set(variables[coll], (path.split(".") if path else []) + [leaf],
             val.contiguous())
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    return variables


# ------------------------------------------------------------------------
# the reference's torch checkpoints -> flax variables (the port's own copy
# of dvd_tpu/training/convert.py; numpy only, torch to read the files)

FlatDict = Dict[str, np.ndarray]


def load_torch_state_dict(path: str, sub_key: Optional[str] = None,
                          strip_prefix: int = 0) -> FlatDict:
    """Read a torch checkpoint into {key: np.ndarray}.

    ``sub_key``: take ``ckpt[sub_key]`` first (the line/seg checkpoints nest
    under 'model'); ``strip_prefix``: drop N leading characters from every
    key (reference reload_model strips 7 for 'module.', reload_segmodel 6
    for 'model.' -- geotr_core.py:1075-1111).
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if sub_key is not None:
        ckpt = ckpt[sub_key]
    out = {}
    for k, v in ckpt.items():
        if strip_prefix:
            k = k[strip_prefix:]
        if hasattr(v, "numpy"):
            out[k] = v.detach().cpu().numpy()
    return out


def _set(tree: dict, path: List[str], leaf) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    if path[-1] in node:
        raise ValueError(f"duplicate destination {'/'.join(path)}")
    node[path[-1]] = leaf


def _convert_leaf(key: str, val: np.ndarray
                  ) -> List[Tuple[str, str, np.ndarray]]:
    """One torch tensor -> [(collection, dest-leaf-name, array), ...].

    ``key`` is the rewritten path whose last segment is the torch attribute
    (weight/bias/running_mean/...).
    """
    attr = key.split(".")[-1]
    if attr == "in_proj_weight":
        d = val.shape[0] // 3
        return [("params", "q_proj.kernel", val[:d].T),
                ("params", "k_proj.kernel", val[d:2 * d].T),
                ("params", "v_proj.kernel", val[2 * d:].T)]
    if attr == "in_proj_bias":
        d = val.shape[0] // 3
        return [("params", "q_proj.bias", val[:d]),
                ("params", "k_proj.bias", val[d:2 * d]),
                ("params", "v_proj.bias", val[2 * d:])]
    if attr == "weight":
        if val.ndim == 4:
            return [("params", "kernel", val.transpose(2, 3, 1, 0))]
        if val.ndim == 2:
            return [("params", "kernel", val.T)]
        return [("params", "scale", val)]  # norm affine
    if attr == "bias":
        return [("params", "bias", val)]
    if attr == "running_mean":
        return [("batch_stats", "mean", val)]
    if attr == "running_var":
        return [("batch_stats", "var", val)]
    if attr == "num_batches_tracked":
        return []
    if attr in ("query_embed", "pos_embed", "row_embed", "col_embed"):
        # bare nn.Parameter / nn.Embedding tables renamed by a rule to
        # their flax leaf name -- pass through unchanged
        return [("params", attr, val)]
    raise ValueError(f"unhandled torch attribute {attr!r} in {key!r}")


def apply_rules(key: str, rules: List[Tuple[str, Optional[str]]]
                ) -> Optional[str]:
    """Apply regex rewrite rules in order; a rule mapping to None drops the
    key (dead parameters)."""
    for pat, repl in rules:
        if repl is None and (re.fullmatch(pat, key.rsplit(".", 1)[0])
                             or re.fullmatch(pat, key)):
            return None
    out = key
    for pat, repl in rules:
        if repl is not None:
            out = re.sub(pat, repl, out)
    return out


def convert_state_dict(sd: FlatDict, rules: List[Tuple[str, Optional[str]]],
                       skip: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """FlatDict + rewrite rules -> flax variables {params: ..., batch_stats:
    ...} of numpy arrays."""
    variables: Dict[str, Any] = {"params": {}}
    for key, val in sorted(sd.items()):
        if any(re.fullmatch(s, key) for s in skip):
            continue
        new_key = apply_rules(key, rules)
        if new_key is None:
            continue
        module_path = new_key.split(".")[:-1]
        for coll, leaf_name, arr in _convert_leaf(new_key, np.asarray(val)):
            variables.setdefault(coll, {})
            _set(variables[coll], module_path + leaf_name.split("."),
                 np.ascontiguousarray(arr))
    return variables


def _listify(*names: str) -> List[Tuple[str, str]]:
    """ModuleList ``name.3.`` -> ``name_3.``."""
    return [(rf"\b({n})\.([0-9]+)\.", r"\1_\2.") for n in names]


DIT_RULES: List[Tuple[str, Optional[str]]] = [
    # dead/deterministic buffers
    (r"noised_obs_pos_embed", None),
    (r"decoder\.position_dec\.(h|w)_position_encoder", None),
    *_listify("blocks", "layer_stack"),
    # private pyramid Sequential indices -> named convs
    (r"pyramid\.level_0\.0\.", r"pyramid.level_0_conv0."),
    (r"pyramid\.level_1\.0\.", r"pyramid.level_1_conv0."),
    (r"pyramid\.level_2\.0\.", r"pyramid.level_2_conv0."),
    (r"pyramid\.level_2\.2\.", r"pyramid.level_2_conv1."),
    (r"pyramid\.level_3\.0\.", r"pyramid.level_3_conv0."),
    (r"pyramid\.level_3\.2\.", r"pyramid.level_3_conv1."),
    (r"pyramid\.level_3\.4\.", r"pyramid.level_3_conv2."),
    # timestep MLP Sequential
    (r"t_embedder\.mlp\.0\.", r"t_embedder.mlp_0."),
    (r"t_embedder\.mlp\.2\.", r"t_embedder.mlp_2."),
    # adaLN Sequential(SiLU, Linear)
    (r"adaLN_modulation\.1\.", r"adaLN_modulation_1."),
    # SATRN decoder: ConvModule .conv/.bn stay; scale nets are Sequentials
    (r"position_dec\.h_scale\.0\.", r"position_dec.h_scale_0."),
    (r"position_dec\.h_scale\.2\.", r"position_dec.h_scale_2."),
    (r"position_dec\.w_scale\.0\.", r"position_dec.w_scale_0."),
    (r"position_dec\.w_scale\.2\.", r"position_dec.w_scale_2."),
]

U2NETP_RULES: List[Tuple[str, Optional[str]]] = []  # names align 1:1

GEOTR_SEG_RULES: List[Tuple[str, Optional[str]]] = [
    # second (dead) cross-attn of each attnLayer is never used
    (r".*multihead_attn_list\.1(\..*)?", None),
    (r".*norm2_list\.1(\..*)?", None),
    (r".*dropout.*", None),
    *_listify("layers"),
    (r"multihead_attn_list\.0\.", r"multihead_attn_0."),
    (r"norm2_list\.0\.", r"norm2_0."),
    # RAFT encoder residual layers: Sequential of 2 blocks
    (r"fnet\.layer([0-9])\.([0-9])\.", r"fnet.layer\1_\2."),
    (r"downsample\.0\.", r"downsample_0."),
    (r"downsample\.1\.", None),  # instance norm: no params
    # update block heads
    (r"update_block\.flow_head\.conv1\.", r"update_block.flow_head_conv1."),
    (r"update_block\.flow_head\.conv2\.", r"update_block.flow_head_conv2."),
    (r"update_block\.mask\.0\.", r"update_block.mask_0."),
    (r"update_block\.mask\.2\.", r"update_block.mask_2."),
    # GeoTr owns query_embed; the TransDecoder holds it
    (r"GeoTr\.query_embed\.weight", r"GeoTr.TransDecoder.query_embed"),
    (r"^query_embed\.weight", r"TransDecoder.query_embed"),
]

LINE_UNET_RULES: List[Tuple[str, Optional[str]]] = [
    (r"inc\.double_conv\.0\.", r"inc.conv_0."),
    (r"inc\.double_conv\.1\.", r"inc.bn_1."),
    (r"inc\.double_conv\.3\.", r"inc.conv_3."),
    (r"inc\.double_conv\.4\.", r"inc.bn_4."),
    (r"(down[0-9])\.maxpool_conv\.1\.double_conv\.0\.", r"\1.conv_0."),
    (r"(down[0-9])\.maxpool_conv\.1\.double_conv\.1\.", r"\1.bn_1."),
    (r"(down[0-9])\.maxpool_conv\.1\.double_conv\.3\.", r"\1.conv_3."),
    (r"(down[0-9])\.maxpool_conv\.1\.double_conv\.4\.", r"\1.bn_4."),
    (r"(up[0-9])\.conv\.double_conv\.0\.", r"\1.conv_0."),
    (r"(up[0-9])\.conv\.double_conv\.1\.", r"\1.bn_1."),
    (r"(up[0-9])\.conv\.double_conv\.3\.", r"\1.conv_3."),
    (r"(up[0-9])\.conv\.double_conv\.4\.", r"\1.bn_4."),
    (r"outc\.conv\.", r"outc."),
]

def unet_qkv_perm(c3: int, num_heads: int) -> np.ndarray:
    """Channel permutation torch -> flax for the improved-diffusion QKV
    conv.

    The reference's ``QKVAttention`` reshapes the 3c qkv channels to
    ``[b*heads, 3c/heads, T]`` and splits per head (``unet.py:218-228``):
    channel j = (head, part in q/k/v, within) at ``j = head*3*dh + part*dh
    + within``.  ``AttentionBlock`` splits the projection globally into
    q|k|v with the heads contiguous inside each: ``j' = part*c + head*dh +
    within``.  Both concatenate the heads contiguously on output, so this
    input-side permutation is the only difference."""
    c = c3 // 3
    dh = c // num_heads
    perm = np.empty(c3, np.int64)
    for h in range(num_heads):
        for p in range(3):
            src = h * 3 * dh + p * dh
            dst = p * c + h * dh
            perm[dst:dst + dh] = np.arange(src, src + dh)
    return perm


def preprocess_unet_attention(sd: FlatDict, num_heads: int) -> FlatDict:
    """Squeeze the reference UNet's 1x1 conv1d attention weights to the 2-D
    linear layout and apply the per-head qkv channel permutation (see
    :func:`unet_qkv_perm`).  ``num_heads`` must equal num_heads_upsample
    (the reference default ``-1`` aliases them)."""
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        if k.endswith(".qkv.weight"):
            v = v[..., 0][unet_qkv_perm(v.shape[0], num_heads)]
        elif k.endswith(".qkv.bias"):
            v = v[unet_qkv_perm(v.shape[0], num_heads)]
        elif k.endswith(".proj_out.weight") and v.ndim == 3:
            v = v[..., 0]
        out[k] = v
    return out


_RESBLOCK_RULES: List[Tuple[str, str]] = [
    # GroupNorm32 wraps an anonymous flax GroupNorm -> extra path segment
    (r"\.in_layers\.0\.", r".norm_in.GroupNorm_0."),
    (r"\.in_layers\.2\.", r".conv_in."),
    (r"\.emb_layers\.1\.", r".emb_proj."),
    (r"\.out_layers\.0\.", r".norm_out.GroupNorm_0."),
    (r"\.out_layers\.3\.", r".conv_out."),
    (r"\.norm\.", r".norm.GroupNorm_0."),  # AttentionBlock pre-norm
]


def unet_rules(channel_mult: Tuple[int, ...] = (1, 2, 3, 4),
               num_res_blocks: int = 3,
               attention_ds: Tuple[int, ...] = (4, 8)
               ) -> List[Tuple[str, str]]:
    """Rewrite rules for ``UNetModel_stage1``/``_sr`` (``unet.py:552-853``)
    -> ``UNetDenoiser``.

    The torch module enumerates its blocks as flat ``input_blocks.{i}`` /
    ``output_blocks.{j}`` ModuleLists whose composition depends on
    (channel_mult, num_res_blocks, attention_ds); this regenerates the
    exact index map for a given config.  Run the state dict through
    :func:`preprocess_unet_attention` first.
    """
    rules: List[Tuple[str, str]] = [
        (r"^time_embed\.0\.", r"time_embed_0."),
        (r"^time_embed\.2\.", r"time_embed_2."),
        (r"^input_blocks\.0\.0\.", r"in_conv."),
        (r"^middle_block\.0\.", r"middle_res1."),
        (r"^middle_block\.1\.", r"middle_attn."),
        (r"^middle_block\.2\.", r"middle_res2."),
        (r"^out\.0\.", r"out_norm.GroupNorm_0."),
        (r"^out\.2\.", r"out_conv."),
    ]
    idx, ds, bi = 1, 1, 0
    for level in range(len(channel_mult)):
        for _ in range(num_res_blocks):
            rules.append((rf"^input_blocks\.{idx}\.0\.", rf"down_{bi}."))
            if ds in attention_ds:
                rules.append((rf"^input_blocks\.{idx}\.1\.",
                              rf"down_attn_{bi}."))
            idx += 1
            bi += 1
        if level != len(channel_mult) - 1:
            rules.append((rf"^input_blocks\.{idx}\.0\.op\.",
                          rf"downsample_{level}."))
            idx += 1
            ds *= 2
    j = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            rules.append((rf"^output_blocks\.{j}\.0\.", rf"up_{j}."))
            li = 1
            if ds in attention_ds:
                rules.append((rf"^output_blocks\.{j}\.{li}\.",
                              rf"up_attn_{j}."))
                li += 1
            if level and i == num_res_blocks:
                rules.append((rf"^output_blocks\.{j}\.{li}\.conv\.",
                              rf"upsample_{level}."))
                ds //= 2
            j += 1
    return rules + _RESBLOCK_RULES


TRANSFORMER_RULES: List[Tuple[str, str]] = [
    # DDIMWithTransformer (transformer.py:57-137); block internals:
    # MultiheadAttention in_proj/out_proj handled by _convert_leaf,
    # ffn Sequential(Linear, ReLU, Linear), post-norms
    (r"^time_embed\.0\.", r"time_embed_0."),
    (r"^time_embed\.2\.", r"time_embed_2."),
    *_listify("input_blocks", "output_blocks"),
    (r"\.ffn\.0\.", r".ffn_0."),
    (r"\.ffn\.2\.", r".ffn_2."),
    (r"^out\.1\.", r"out_1."),
]

VGG16_RULES: List[Tuple[str, Optional[str]]] = [
    (r"classifier\..*", None),
    (r"features\.0\.", r"level_0_conv0."),
    (r"features\.2\.", r"level_1_conv0."),
    (r"features\.5\.", r"level_2_conv0."),
    (r"features\.7\.", r"level_2_conv1."),
    (r"features\.(1[79]|2[1-9]).*", None),  # levels beyond /8 unused
    (r"features\.10\.", r"level_3_conv0."),
    (r"features\.12\.", r"level_3_conv1."),
    (r"features\.14\.", r"level_3_conv2."),
]


def validate_against(variables: Mapping, reference_vars: Mapping,
                     collection: str = "params") -> List[str]:
    """Compare a converted tree's structure and shapes with a reference
    tree; a list of readable problems (empty = exact match)."""
    got = flatten_tree(variables.get(collection, {}))
    want = flatten_tree(reference_vars.get(collection, {}))
    problems = []
    for k in sorted(set(want) - set(got)):
        problems.append(f"missing {collection}/{k} {tuple(want[k].shape)}")
    for k in sorted(set(got) - set(want)):
        problems.append(f"unexpected {collection}/{k} {tuple(got[k].shape)}")
    for k in sorted(set(got) & set(want)):
        if tuple(got[k].shape) != tuple(want[k].shape):
            problems.append(f"shape mismatch {collection}/{k}: "
                            f"{tuple(got[k].shape)} vs {tuple(want[k].shape)}")
    return problems
