"""CUDA-graph replay of the frozen conditioning networks
(``dvd_tpu_torch/utils/graphs.py``) on the CPU: a serving pipeline enables
it on GeoTrSegInf, Seg's U2NetP and the line UNet, a training one does
not; a CPU input or a call with autograd on takes the eager path,
counted and spanned, with ``build_conditioning``'s outputs unchanged bit
for bit; a wrapper set on the ``seg.msk.forward`` instance sees every
call; the keys a graph is kept under, and the weights key that drops a
module's graphs after ``load_state_dict``, ``.to()`` or a replaced
submodule; what a capture holds and the launches it notes.  The card's half (capture, replay) is
``tests/test_torch_graphs_cuda.py``."""

import copy

import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, graphed_nets
from dvd_tpu_torch.models.layers import conv3x3_folded, fold_conv_bn
from dvd_tpu_torch.ops import resize
from dvd_tpu_torch.utils import graphs, trace
from test_torch_common import SRC, TINY_MODEL

NETS = ("geotr", "seg", "line")


def _cfg():
    return default_config().replace(
        model=dict(TINY_MODEL, dit_variant="DiT-mini"),
        diffusion={"n_batch": 2})


@pytest.fixture(scope="module")
def pipe():
    return DewarpPipeline.create(_cfg(), "cpu",
                                 generator=torch.Generator().manual_seed(0))


@pytest.fixture(autouse=True)
def clean():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _nets(pipe):
    return graphed_nets(pipe.geotr, pipe.seg, pipe.line)


def _sources(b=2, seed=0):
    return torch.rand((b, SRC, SRC, 3),
                      generator=torch.Generator().manual_seed(seed))


def _conditioning(pipe, src):
    with torch.inference_mode():
        cond, init_flow, init_feat = pipe.build_conditioning(src)
    return dict(cond, init_flow=init_flow, init_feat=init_feat)


def _perception(pipe, b=2, seed=1):
    per = pipe.cfg.model.perception_size
    return torch.rand((b, 3, per, per),
                      generator=torch.Generator().manual_seed(seed))


def _forward_of(net, module):
    return module._mask_branch if net == "geotr" else module._forward


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def test_serving_pipeline_enables_its_three_networks(pipe):
    for net, module in _nets(pipe).items():
        g = graphs.graphs_of(module)
        assert g is not None and g.net == net and not g.graphs
    # GeoTrSegInf's own U2NetP runs inside the geotr graph: not enabled
    assert graphs.graphs_of(pipe.geotr.msk) is None
    assert graphs.MAX_KEYS == 4


def test_training_pipeline_enables_none():
    cfg = _cfg()
    tp = DewarpPipeline.create(cfg, "cpu", train=True,
                               generator=torch.Generator().manual_seed(0))
    assert all(graphs.graphs_of(m) is None for m in _nets(tp).values())
    before = dict(graphs.counts)
    with torch.inference_mode():
        tp.seg.msk(_perception(tp))
    assert dict(graphs.counts) == before


def test_cpu_input_takes_the_eager_path_bit_for_bit(pipe):
    src = _sources()
    before = {n: graphs.counts[n, "eager"] for n in NETS}
    got = [_conditioning(pipe, src) for _ in range(3)]
    assert {n: graphs.counts[n, "eager"] - before[n] for n in NETS} == \
        {n: 3 for n in NETS}
    assert all(graphs.counts[n, m] == 0 for n in NETS
               for m in ("capture", "replay"))
    assert all(not graphs.graphs_of(m).graphs and not graphs.graphs_of(m).warm
               for m in _nets(pipe).values())
    saved = {n: graphs.graphs_of(m) for n, m in _nets(pipe).items()}
    try:
        for m in _nets(pipe).values():
            graphs.disable(m)
        want = _conditioning(pipe, src)
    finally:
        for n, m in _nets(pipe).items():
            m.__dict__[graphs.ATTR] = saved[n]
    for cond in got:
        assert cond.keys() == want.keys()
        for k in want:
            assert _same(cond[k], want[k]), k


@pytest.mark.parametrize("net", NETS)
def test_autograd_on_takes_the_eager_path(pipe, net):
    module = _nets(pipe)[net]
    x = _perception(pipe)
    before = graphs.counts[net, "eager"]
    with torch.enable_grad():
        got = module(x)
    assert graphs.counts[net, "eager"] == before + 1
    with torch.no_grad():
        want = _forward_of(net, module)(x)
    if net == "geotr":          # (no GeoTr map, the soft mask upsampled)
        assert got[0] is None
        got, want = got[1], want[1]
    assert _same(got, want)


def test_eager_spans_nest_in_their_networks_spans(pipe):
    trace.enable()
    _conditioning(pipe, _sources())
    recs = trace.records()
    spans = [(i, r) for i, r in enumerate(recs) if r[0] == graphs.SPAN]
    assert [r[5] for _, r in spans] == [
        {"net": n, "mode": "eager"} for n in NETS]
    for _, r in spans:
        parent = recs[r[4]]
        assert parent[0] == f"dvd.cond.{r[5]['net']}"
        assert parent[1] <= r[1] <= r[2] <= parent[2]


def test_a_wrapper_on_the_instance_sees_every_call(pipe):
    seg = pipe.seg.msk
    forward = seg.forward
    seen = []

    def wrapped(x):
        out = forward(x)
        seen.append(out[0])
        return out

    seg.forward = wrapped
    try:
        for i in range(3):
            _conditioning(pipe, _sources(seed=i))
    finally:
        del seg.forward
    assert len(seen) == 3
    assert not torch.equal(seen[0], seen[1])
    assert seg.forward.__func__ is type(seg).forward


@pytest.mark.parametrize("net", NETS)
def test_load_state_dict_and_to_change_the_weights_key(pipe, net):
    module = copy.deepcopy(_nets(pipe)[net])
    g = graphs.graphs_of(module)
    k0 = g.weights_key(module)
    assert g.weights_key(module) == k0
    module.to("cpu")                        # no move: the same tensors
    assert g.weights_key(module) == k0
    module.load_state_dict(module.state_dict())
    k1 = g.weights_key(module)
    assert k1 != k0 and len(k1) == len(k0)
    module.to(torch.float64)
    k2 = g.weights_key(module)
    assert k2 != k1
    # a parameter replaced by assignment is seen too
    conv = next(m for m in module.modules()
                if isinstance(m, torch.nn.Conv2d))
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone(),
                                     requires_grad=False)
    assert g.weights_key(module) != k2


def test_a_replaced_submodule_changes_the_weights_key(pipe):
    module = copy.deepcopy(pipe.seg.msk)
    g = graphs.graphs_of(module)
    k0 = g.weights_key(module)
    stage = module.stage1
    module.stage1 = copy.deepcopy(stage)    # new tensors, deeper in the tree
    k1 = g.weights_key(module)
    assert k1 != k0 and len(k1) == len(k0)
    assert any(m is module.stage1 for m in g.tree)
    assert not any(m is stage for m in g.tree)
    inner = next(m for m in module.stage1.modules()
                 if isinstance(m, torch.nn.Conv2d))
    parent = next(m for m in module.stage1.modules()
                  if any(c is inner for c in m._modules.values()))
    name = next(k for k, c in parent._modules.items() if c is inner)
    setattr(parent, name, copy.deepcopy(inner))
    assert g.weights_key(module) != k1


def test_a_weights_change_drops_the_graphs_and_warm_keys(pipe):
    module = copy.deepcopy(pipe.line)
    g = graphs.graphs_of(module)
    g.refresh(module)
    g.graphs[("shape",)], g.warm = object(), {("other",)}
    g.pool = ("pool",)
    g.refresh(module)                       # unchanged: kept
    assert g.graphs and g.warm and g.pool
    with torch.no_grad():
        module.inc.conv_0.bias.add_(1.0)
    g.refresh(module)
    assert not g.graphs and not g.warm and g.pool is None


def test_input_key_tells_shapes_dtypes_strides_and_tf32_apart():
    x = torch.zeros((4, 3, 8, 8))
    keys = {graphs.input_key(x),
            graphs.input_key(torch.zeros((16, 3, 8, 8))),
            graphs.input_key(x.to(torch.bfloat16)),
            graphs.input_key(x.to(memory_format=torch.channels_last))}
    assert len(keys) == 4
    assert graphs.input_key(torch.ones((4, 3, 8, 8))) == graphs.input_key(x)
    for backend in (torch.backends.cuda.matmul, torch.backends.cudnn):
        saved = backend.allow_tf32
        k = graphs.input_key(x)
        try:
            backend.allow_tf32 = not saved
            assert graphs.input_key(x) != k
        finally:
            backend.allow_tf32 = saved


def test_a_copied_module_starts_without_graphs(pipe):
    g = graphs.graphs_of(pipe.seg.msk)
    g.warm.add(("shape",))
    try:
        module = copy.deepcopy(pipe.seg.msk)
    finally:
        g.warm.clear()
    c = graphs.graphs_of(module)
    assert c is not g and c.net == "seg"
    assert not c.graphs and not c.warm and c.values is None


def test_a_capture_holds_the_fold_and_resize_tensors_it_reads(pipe):
    x = _perception(pipe)
    graphs.hold(x)                          # no capture open: nothing kept
    assert not graphs.capturing()
    conv, bn = pipe.line.inc.conv_0, pipe.line.inc.bn_1
    with graphs.holding() as held:
        assert graphs.capturing()
        y = resize.resize_bilinear(x, (8, 8), False)
        conv3x3_folded(conv, bn, x, True)
    assert not graphs.capturing()
    a = resize._linear_weights(x.shape[2], 8, False, x.device, x.dtype)
    assert any(t is a for t in held)
    assert any(t is fold_conv_bn(conv, bn, x.dtype) for t in held)
    assert y.shape == (2, 3, 8, 8)


def test_launches_are_noted_only_inside_a_capture():
    graphs.launched("conv3x3", 4, 16, 16, 8, 8, 2)   # none open: dropped
    assert graphs.launches() == ()
    with graphs.holding():
        graphs.launched("conv3x3", 4, 16, 32, 8, 8, 2)
        graphs.launched("conv3x3", 4, 32, 16, 4, 4, 2)
        noted = graphs.launches()
    assert noted == (("conv3x3", 4, 16, 32, 8, 8, 2),
                     ("conv3x3", 4, 32, 16, 4, 4, 2))
    assert graphs.launches() == ()


def test_inside_a_capture_an_enabled_network_runs_as_it_is(pipe):
    before = dict(graphs.counts)
    x = _perception(pipe)
    with graphs.holding(), torch.inference_mode():
        got = pipe.line(x)
        want = pipe.line._forward(x)
    assert dict(graphs.counts) == before
    assert _same(got, want)


def test_a_disabled_network_runs_uncounted(pipe):
    module = copy.deepcopy(pipe.seg.msk)
    graphs.disable(module)
    assert graphs.graphs_of(module) is None
    before = dict(graphs.counts)
    with torch.inference_mode():
        module(_perception(pipe))
    assert dict(graphs.counts) == before
