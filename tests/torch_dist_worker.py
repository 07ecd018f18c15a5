"""One rank of a ``torch.distributed`` world for the port's parallel-layer
tests (not a test module): the test spawns one process per rank with

    python tests/torch_dist_worker.py CASE RANK WORLD PORT SPEC.pt OUT

and reads what rank 0 writes to OUT.  It imports torch and the port
only, joins a gloo group on the CPU at ``tcp://127.0.0.1:PORT`` and runs:

- ``step``: one train step of a DiT built from ``spec["dit"]`` with the
  weights ``spec["state_dict"]`` on this rank's rows of the global batch
  ``spec["batch"]`` (the pins ``t``, ``noise``, ``rollout_noise`` are
  the global batch's) on the mesh ``spec["mesh"]`` with ``fsdp``, in
  ``spec["dtype"]`` (float32 by default); writes
  the loss, the gradients, parameters and EMA gathered to the unsharded
  layout, the BN running statistics, the per-sample metrics of the global
  batch, each sharded parameter's placement and local shape, and
  ``multihost_weighted_means`` over disjoint key sets;
- ``train``: ``train()`` on the mesh over the wire batches of
  ``spec["batches"]`` from index ``spec["start"]`` (global batches; each
  rank feeds its rows) to ``spec["max_steps"]``, which saves its
  checkpoint into the workspace of ``spec["cfg"]``;
- ``serve``: ``run_benchmark`` of a tiny pipeline (``spec["cfg"]``,
  ``spec["dit"]``, the networks' state_dicts ``spec["weights"]``) over
  the pages in ``spec["pages"]`` into ``spec["out_dir"]`` on the mesh.
"""

import datetime
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)


def _config(over):
    from dvd_tpu_torch.config import default_config

    return default_config().replace(**over)


def _dit(kw):
    from dvd_tpu_torch.models.dit import DiT

    return DiT(dropout=0.0, **kw)


def case_step(spec, mesh):
    from dvd_tpu_torch.diffusion.schedule import make_schedule
    from dvd_tpu_torch.parallel.mesh import batch_slice, gather_batch
    from dvd_tpu_torch.training.checkpoint import unsharded_state
    from dvd_tpu_torch.training.train_state import (create_train_state,
                                                    make_train_step,
                                                    microbatch_chunks,
                                                    shard_train_state)
    from dvd_tpu_torch.utils.logger import multihost_weighted_means

    cfg = _config(spec["cfg"])
    dtype = spec.get("dtype", torch.float32)
    net = _dit(spec["dit"])
    net.load_state_dict(spec["state_dict"])
    net.to(dtype)
    state = shard_train_state(cfg, create_train_state(cfg, net), mesh,
                              cfg.parallel.fsdp)
    step = make_train_step(cfg, make_schedule(steps=3, device="cpu"),
                           mesh=mesh)
    gb = spec["batch"]
    n = gb["flow64"].shape[0] // mesh.data
    k = microbatch_chunks(cfg, n)
    rows = batch_slice(mesh, n, k)
    batch = {key: v[rows].to(dtype) for key, v in gb.items()}
    record = {}
    opt_step = state.optimizer.step

    def recording_step(grads):
        record["grads"] = [g.clone() for g in grads]
        return opt_step(grads)

    state.optimizer.step = recording_step
    pins = {key: spec[key] for key in ("t", "noise", "rollout_noise")
            if spec.get(key) is not None}
    pins.update({key: v.to(dtype) for key, v in pins.items()
                 if v.is_floating_point()})
    state, m = step(state, batch, None, **pins)
    lay = state.layout
    names = list(lay.held)
    model_sd, _, ema = unsharded_state(state)
    out = {
        "loss": m["loss"].item(), "mse": m["mse"].item(),
        "grad_norm": m["grad_norm"].item(),
        "grads": {nm: lay.unsharded(nm, g)
                  for nm, g in zip(names, record["grads"])},
        "state": model_sd, "ema": ema[0],
        "placements": {nm: (pl.kind, pl.axis, tuple(lay.held[nm].shape)
                            if nm in lay.fsdp else
                            tuple(state.named_params()[nm].shape))
                       for nm, pl in lay.placements.items()},
        "heads": {nm: getattr(mod, "num_heads", getattr(mod, "n_head", None))
                  for nm, mod in state.model.named_modules()
                  if hasattr(mod, "num_heads") or hasattr(mod, "n_head")},
        "rows": rows,
        "local": {nm: state.named_params()[nm].detach()
                  for nm, pl in lay.placements.items() if pl.kind == "model"},
    }
    for key in ("t", "loss_per_sample", "mse_per_sample"):
        out[key] = gather_batch(m[key], mesh, k)
    if state.sampler_state is not None:
        out["history"] = state.sampler_state.history
    means = ({"loss_q0": (2.0, 2), "shared": (1.0, 1)} if mesh.rank == 0
             else {"loss_q2": (9.0, 3), "shared": (3.0, 1)})
    out["means"] = multihost_weighted_means(means)
    return out


def case_train(spec, mesh):
    from dvd_tpu_torch.models.dit import DIT_CONFIGS
    from dvd_tpu_torch.parallel.mesh import batch_slice
    from dvd_tpu_torch.training.train_loop import train

    DIT_CONFIGS.update(spec.get("dit_configs", {}))
    cfg = _config(spec["cfg"])

    def batches():
        for gb in spec["batches"][spec.get("start", 0):]:
            n = next(iter(gb.values())).shape[0] // mesh.data
            rows = batch_slice(mesh, n).numpy()
            yield {key: v[rows] for key, v in gb.items()}

    state = train(cfg, batches(), max_steps=spec["max_steps"], device="cpu",
                  mesh=mesh)
    return {"step": state.step,
            "sharded": sorted(state.layout.placements)}


def case_serve(spec, mesh):
    from dvd_tpu_torch.data.benchmark import BenchmarkDataset
    from dvd_tpu_torch.evaluation.driver import run_benchmark
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline

    cfg = _config(spec["cfg"])
    pipe = DewarpPipeline.create(cfg, "cpu", dit=_dit(spec["dit"]))
    for name, sd in spec["weights"].items():
        getattr(pipe, name).load_state_dict(sd)
    ds = BenchmarkDataset.from_dir(spec["pages"],
                                   source_size=cfg.model.source_size)
    stats = run_benchmark(pipe, ds, spec["out_dir"],
                          batch_size=spec["batch"], seed=spec["seed"],
                          save_coord_maps=True, mesh=mesh)
    qkv = pipe.dit.get_submodule(spec["probe"])
    return {"stats": stats, "probe": (type(qkv).__name__,
                                      tuple(qkv.weight.shape))}


def main():
    case, rank, world, port, spec_path, out_path = sys.argv[1:]
    rank, world = int(rank), int(world)
    from dvd_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed("gloo", "cpu", rank=rank, world_size=world,
                     init_method=f"tcp://127.0.0.1:{port}")
    try:
        spec = torch.load(spec_path, weights_only=False)
        mesh = make_mesh(*spec["mesh"])
        out = {"step": case_step, "train": case_train,
               "serve": case_serve}[case](spec, mesh)
        dist.barrier(timeout=datetime.timedelta(seconds=60))
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
