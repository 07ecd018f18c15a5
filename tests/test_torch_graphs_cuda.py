"""CUDA-graph replay of the frozen conditioning networks
(``dvd_tpu_torch/utils/graphs.py``) on the card: at the serving batches 4
and 16, each graphed network's capture and replays equal its eager forward
bit for bit, and so does ``build_conditioning``; a replay's outputs stay
as they were after the next replay; weights loaded after a replay give the
new weights' eager outputs; two batch sizes keep a graph each; a wrapper
on the ``seg.msk.forward`` instance sees each batch's ``d0``; K2 is the
captured kernel, and a replay's span lists each K2 launch of its graph.  Every test is marked ``cuda`` and skips without a card;
the file imports neither JAX nor ``dvd_tpu``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graphs_cuda.py

The CPU half is ``tests/test_torch_graphs.py``.
"""

import pytest
import torch

from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, graphed_nets
from dvd_tpu_torch.ops.kernels.conv3x3 import conv3x3
from dvd_tpu_torch.utils import graphs, trace

pytestmark = pytest.mark.cuda
NETS = ("geotr", "seg", "line")


@pytest.fixture(scope="module")
def pipe():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs replay on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = default_config().replace(model={"dit_variant": "DiT-mini"})
    return DewarpPipeline.create(cfg, "cuda",
                                 generator=torch.Generator().manual_seed(0))


def _nets(pipe):
    return graphed_nets(pipe.geotr, pipe.seg, pipe.line)


def _fresh_graphs(pipe):
    for net, module in _nets(pipe).items():
        graphs.enable(module, net)


def _x(pipe, b, seed):
    per = pipe.cfg.model.perception_size
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((b, 3, per, per), generator=g, device="cuda").to(
        pipe.dtype)


def _sources(pipe, b, seed):
    s = pipe.cfg.model.source_size
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((b, s, s, 3), generator=g, device="cuda")


def _eager(net, module, x):
    fn = module._mask_branch if net == "geotr" else module._forward
    out = fn(x)
    return out[1:] if net == "geotr" else out


def _call(net, module, x):
    out = module(x)
    return out[1:] if net == "geotr" else out


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def _clone(out):
    return tuple(t.clone() for t in out)


def _modes(net):
    return {m: graphs.counts[net, m] for m in ("eager", "capture", "replay")}


@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("net", NETS)
def test_capture_and_replays_equal_eager(pipe, net, b):
    _fresh_graphs(pipe)
    module = _nets(pipe)[net]
    with torch.inference_mode():
        for i, mode in enumerate(("eager", "capture", "replay", "replay")):
            x = _x(pipe, b, 10 * b + i)
            c0 = _modes(net)
            got = _call(net, module, x)
            c1 = _modes(net)
            assert {m: c1[m] - c0[m] for m in c1} == \
                {m: int(m == mode) for m in c1}
            assert _same(got, _eager(net, module, x)), (net, b, mode)
    assert len(graphs.graphs_of(module).graphs) == 1


@pytest.mark.parametrize("b", [4, 16])
def test_build_conditioning_replay_equals_eager(pipe, b):
    _fresh_graphs(pipe)
    srcs = [_sources(pipe, b, 100 + i) for i in range(4)]
    with torch.inference_mode():
        got = [pipe.build_conditioning(s) for s in srcs]
        saved = {n: graphs.graphs_of(m) for n, m in _nets(pipe).items()}
        for m in _nets(pipe).values():
            graphs.disable(m)
        want = [pipe.build_conditioning(s) for s in srcs]
    for n, m in _nets(pipe).items():
        m.__dict__[graphs.ATTR] = saved[n]
    assert all(len(saved[n].graphs) == 1 for n in NETS)
    for (gc, gf, gi), (wc, wf, wi) in zip(got, want):
        assert gc.keys() == wc.keys()
        for k in wc:
            assert _same(gc[k], wc[k]), k
        assert _same(gf, wf) and _same(gi, wi)


@pytest.mark.parametrize("net", NETS)
def test_a_replays_outputs_survive_the_next_replay(pipe, net):
    _fresh_graphs(pipe)
    module = _nets(pipe)[net]
    with torch.inference_mode():
        for i in range(2):
            _call(net, module, _x(pipe, 4, i))
        xa, xb = _x(pipe, 4, 7), _x(pipe, 4, 8)
        out_a = _call(net, module, xa)
        kept = _clone(out_a)
        out_b = _call(net, module, xb)
        torch.cuda.synchronize()
        assert _same(out_a, kept) and _same(out_a, _eager(net, module, xa))
        assert _same(out_b, _eager(net, module, xb))
        assert not _same(out_a, out_b)


@pytest.mark.parametrize("net", NETS)
def test_weights_loaded_after_a_replay_give_their_eager_outputs(pipe, net):
    _fresh_graphs(pipe)
    module = _nets(pipe)[net]
    old = {k: v.clone() for k, v in module.state_dict().items()}
    x = _x(pipe, 4, 3)
    try:
        with torch.inference_mode():
            for _ in range(3):
                before = _call(net, module, x)
            g = torch.Generator().manual_seed(99)
            new = {k: v + 0.05 * torch.randn(v.shape, generator=g).to(v)
                   if v.is_floating_point() else v for k, v in old.items()}
            module.load_state_dict(new)
            counts = _modes(net)
            for mode in ("eager", "capture", "replay"):
                got = _call(net, module, x)
                assert _modes(net)[mode] == counts[mode] + 1, mode
                assert _same(got, _eager(net, module, x)), mode
                assert not _same(got, before), mode
    finally:
        module.load_state_dict(old)


def test_two_batch_sizes_keep_a_graph_each(pipe):
    _fresh_graphs(pipe)
    module = pipe.seg.msk
    before = _modes("seg")
    with torch.inference_mode():
        for i in range(3):
            for b in (4, 16):
                x = _x(pipe, b, 50 + i)
                assert _same(module(x), module._forward(x)), (i, b)
    after = _modes("seg")
    assert {m: after[m] - before[m] for m in after} == \
        {"eager": 2, "capture": 2, "replay": 2}
    assert sorted(k[0][0] for k in graphs.graphs_of(module).graphs) == [4, 16]


def test_past_max_keys_calls_run_eagerly(pipe):
    _fresh_graphs(pipe)
    module = pipe.line
    sizes = range(1, graphs.MAX_KEYS + 2)
    with torch.inference_mode():
        for _ in range(2):
            for b in sizes:
                module(_x(pipe, b, b))
        before = _modes("line")
        x = _x(pipe, graphs.MAX_KEYS + 1, 0)
        assert _same(module(x), module._forward(x))
    assert len(graphs.graphs_of(module).graphs) == graphs.MAX_KEYS
    assert _modes("line")["eager"] == before["eager"] + 1


def test_the_instance_wrapper_sees_each_batchs_d0(pipe):
    """perfbench's way of reading Seg's soft mask: ``pipe.seg.msk.forward``
    wrapped on the instance keeps each batch's d0 across batches."""
    _fresh_graphs(pipe)
    seg = pipe.seg.msk
    forward = seg.forward
    seen = []

    def wrapped(x):
        out = forward(x)
        seen.append((x.clone(), out[0]))
        return out

    seg.forward = wrapped
    try:
        with torch.inference_mode():
            for i in range(5):
                pipe.build_conditioning(_sources(pipe, 4, 200 + i))
    finally:
        del seg.forward
    assert len(seen) == 5
    with torch.inference_mode():
        for x, d0 in seen:
            assert _same(d0, seg._forward(x)[0])


def test_k2_is_the_captured_kernel_and_autograd_stays_eager(pipe):
    """The capture launches K2 through its wrapper twice (the side stream's
    pass, the capture) per eager call's launches, on the bf16 route; a
    replay launches none from Python; with autograd on the call is
    eager."""
    _fresh_graphs(pipe)
    module = pipe.seg.msk
    launched = []
    with torch.inference_mode():
        for i in range(3):
            n0 = conv3x3.launches_wgmma
            module(_x(pipe, 4, i))
            launched.append(conv3x3.launches_wgmma - n0)
    assert launched[0] > 100 and launched[1] == 2 * launched[0]
    assert launched[2] == 0
    before = _modes("seg")
    with torch.no_grad(), torch.enable_grad():
        n0 = conv3x3.launches_wgmma
        x = _x(pipe, 4, 0)
        got = module(x)
        assert conv3x3.launches_wgmma - n0 == launched[0]
    assert _modes("seg")["eager"] == before["eager"] + 1
    with torch.inference_mode():
        assert _same(got, module._forward(x))


@pytest.mark.parametrize("net", NETS)
def test_a_replays_span_lists_its_graphs_k2_launches(pipe, net):
    _fresh_graphs(pipe)
    module = _nets(pipe)[net]
    x = _x(pipe, 4, 7)
    with torch.inference_mode():
        module(x)
        n0 = conv3x3.launches_wgmma
        module._forward(x) if net != "geotr" else module._mask_branch(x)
        eager = conv3x3.launches_wgmma - n0
        module(x)                           # the capture
        trace.clear()
        trace.enable()
        try:
            module(x)
        finally:
            trace.disable()
    spans = [r for r in trace.records() if r[0] == graphs.SPAN]
    trace.clear()
    assert [r[5]["mode"] for r in spans] == ["replay"]
    launches = spans[0][5]["launches"]
    assert len(launches) == eager > 0
    assert {n for n, *_ in launches} == {"conv3x3"}
    assert all(b == 4 and itemsize == 2
               for _, b, cin, cout, h, w, itemsize in launches)
