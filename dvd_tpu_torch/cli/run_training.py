"""Train with the PyTorch/CUDA port (the counterpart of ``run_training.py``).

    # a Doc3D-layout dataset (img.png / bm.mat / recon.png per sample)
    python -m dvd_tpu_torch.cli.run_training --data_root /data/doc3d \
        --set train.batch_size=10 [--max_steps N] [--device cuda]

    # N synthetic pages written under data.data_root/synthetic (or
    # checkpoints/synthetic_doc3d) and trained on through the same path
    python -m dvd_tpu_torch.cli.run_training --synthetic 64 --max_steps 100

    # one process per device under torchrun (on the CPU: --device cpu,
    # gloo); cfg.parallel lays out the (data, model) mesh
    torchrun --nproc_per_node 2 -m dvd_tpu_torch.cli.run_training \
        --multihost --synthetic 64 --max_steps 100

Reading the datasets needs cv2 and h5py (imported when a file is read).
With ``train.on_device_aug`` (the default) the loader ships each sample's
composited image, mask and backward map, and the warp and jitter run on
the training device; a set that fits ``train.device_dataset_max_gb`` is
staged there once (``train.device_dataset``).  Checkpoints, EMA snapshots
and logs go to ``paths.workspace_dir``; a rerun resumes from the latest
``state_*.pt`` there.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import subprocess
import sys
from typing import Dict, Iterator

import numpy as np
import torch
import torch.distributed as dist

# the bytes a staged sample takes on the device: the image as uint8, the
# mask and the flow as f32
STAGED_BYTES_PER_PIXEL = 3 + 4 + 2 * 4


def data_iterator(cfg, seed: int, device="cuda", mesh=None):
    """The data pipeline for ``cfg.data.dataset_name``: the device-resident
    set when ``_device_dataset_ok``, else a :class:`PrefetchLoader` of
    numpy batches.  ``train.batch_size`` is the per-process batch; under a
    ``mesh`` the loader takes the data index's stride of the epoch order
    (the ranks of one model group read the same batches)."""
    from dvd_tpu_torch.data.doc3d import (Doc3DDataset, load_texture_list,
                                          make_doc3d_sample_list)
    from dvd_tpu_torch.data.doc_npz import (AugDocNpzDataset, DocNpzDataset,
                                            make_doc_sample_list)
    from dvd_tpu_torch.data.loader import PrefetchLoader

    textures = (load_texture_list(cfg.data.texture_list)
                if cfg.data.texture_list else ())
    # the reference's dataset_name switch (train_TDiff.py:99-127)
    name = cfg.data.dataset_name
    dev_aug = cfg.train.on_device_aug
    it, iT = cfg.data.inter_t, cfg.data.inter_T
    if name == "doc3d":
        ds = Doc3DDataset(samples=make_doc3d_sample_list(cfg.data.data_root),
                          textures=textures, inter_t=it, inter_T=iT,
                          device_aug=dev_aug)
    elif name == "doc_debug":
        if dev_aug:
            raise ValueError("on_device_aug requires an augmenting dataset "
                             "(doc3d | aug_doc); doc_debug has no warp/jitter")
        ds = DocNpzDataset(samples=make_doc_sample_list(cfg.data.data_root))
    elif name == "aug_doc":
        ds = AugDocNpzDataset(samples=make_doc_sample_list(cfg.data.data_root),
                              textures=textures, inter_t=it, inter_T=iT,
                              device_aug=dev_aug)
    else:
        raise ValueError(f"unknown dataset_name {name!r} "
                         "(doc3d | doc_debug | aug_doc)")
    keys = (("image512", "doc_mask512", "flow_map") if dev_aug
            else ("source_image", "doc_mask", "flow_map", "flow_map_inter"))
    if dev_aug and _device_dataset_ok(cfg, ds):
        return device_resident_iterator(cfg, ds, seed, device)
    return PrefetchLoader(ds, batch_size=cfg.train.batch_size,
                          num_workers=cfg.data.n_threads, seed=seed,
                          keys=keys,
                          process_index=mesh.data_index if mesh else 0,
                          process_count=mesh.data if mesh else 1)


def _device_dataset_ok(cfg, ds) -> bool:
    """Stage the set on the device?  ``train.device_dataset``: "off" never,
    "auto" when its staged bytes fit ``train.device_dataset_max_gb``, "on"
    always, raising when they do not fit.  Never under more than one
    process (each would stage the whole set), as ``dvd_tpu``."""
    mode = cfg.train.device_dataset
    if mode == "off" or (dist.is_initialized()
                         and dist.get_world_size() != 1):
        return False
    gb = len(ds.samples) * 512 * 512 * STAGED_BYTES_PER_PIXEL / 1e9
    ok = gb <= cfg.train.device_dataset_max_gb
    if mode == "on" and not ok:
        raise ValueError(f"device_dataset=on but the dataset is ~{gb:.1f} GB "
                         f"(> train.device_dataset_max_gb)")
    return ok


def device_resident_iterator(cfg, ds, seed: int, device="cuda"
                             ) -> Iterator[Dict[str, torch.Tensor]]:
    """Stage every raw (pre-augmentation) sample on ``device`` once, then
    yield batches gathered there (``index_select``): no host-to-device
    traffic in the steady state.

    Item i is ``ds.__getitem__(i, seed * 100003 + i)``, staged as the
    image rounded to uint8 (``np.rint``: the composited image is not
    whole levels, and a plain cast would truncate it), the soft mask and
    the flow as f32 (exact, fractional edge pixels included).  The
    intermediate warp and the jitter stay per step on the device
    (``data/device_aug.py``), so batches stay fresh across epochs; the
    host-side crop and background are drawn once per staging, at
    ``seed``.  Batches follow ``np.random.RandomState(seed)``'s
    permutations, a new one when the next batch would run past the end of
    the current one (``dvd_tpu``'s draws)."""
    n = len(ds.samples)
    imgs, masks, flows = [], [], []
    for i in range(n):
        item = ds.__getitem__(i, seed=seed * 100003 + i)
        imgs.append(np.clip(np.rint(item["image512"]), 0, 255)
                    .astype(np.uint8))
        masks.append(np.asarray(item["doc_mask512"], np.float32))
        flows.append(np.asarray(item["flow_map"], np.float32))
    dev_img = torch.from_numpy(np.stack(imgs)).to(device)
    dev_msk = torch.from_numpy(np.stack(masks)).to(device)
    dev_flow = torch.from_numpy(np.stack(flows)).to(device)
    staged = sum(t.numel() * t.element_size()
                 for t in (dev_img, dev_msk, dev_flow))
    print(f"device-resident dataset: {n} samples, {staged / 1e6:.0f} MB "
          f"staged on {device}", flush=True)

    b = cfg.train.batch_size
    rng = np.random.RandomState(seed)

    def gen():
        order = rng.permutation(n)
        pos = 0
        while True:
            if pos + b > n:
                order = rng.permutation(n)
                pos = 0
            idx = torch.from_numpy(order[pos:pos + b]).to(device)
            pos += b
            yield {"image512": dev_img.index_select(0, idx).float(),
                   "doc_mask512": dev_msk.index_select(0, idx),
                   "flow_map": dev_flow.index_select(0, idx)}

    return gen()


def _run_segments(ap, args):
    """Train as a chain of child processes of at most ``segment_steps``
    steps each.  Each child saves its final state on exit and the next
    resumes from it; the loader gets a new seed per segment, while the
    step's random draws follow the global step, so segmenting leaves them
    as they were."""
    if not args.max_steps:
        ap.error("--segment_steps requires --max_steps")
    if args.segment_steps < 1:
        ap.error("--segment_steps must be >= 1")

    from dvd_tpu_torch.cli.run_sampling import parse_overrides
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.training.checkpoint import latest_checkpoint

    cfg = dataclasses.replace(
        default_config().replace(**parse_overrides(args.overrides)),
        name=args.name)
    ws = os.path.join(cfg.paths.workspace_dir, cfg.name)

    def latest_step() -> int:
        path = latest_checkpoint(ws)     # state_%08d.pt, the step's number
        return int(re.search(r"(\d+)\.pt$", path).group(1)) if path else 0

    child_base = [sys.executable, "-m", "dvd_tpu_torch.cli.run_training",
                  "--train_module", args.train_module,
                  "--train_name", args.train_name,
                  "--name", args.name, "--seed", str(args.seed),
                  "--device", args.device]
    for ov in args.overrides or ():
        child_base += ["--set", ov]
    if args.data_root:
        child_base += ["--data_root", args.data_root]
    if args.synthetic:
        child_base += ["--synthetic", str(args.synthetic)]
    if args.multihost:
        child_base += ["--multihost"]

    seg = 0
    while True:
        start = latest_step()
        if start >= args.max_steps:
            print(f"segments done: step {start} >= {args.max_steps}")
            return
        budget = min(start + args.segment_steps, args.max_steps)
        child = child_base + [
            "--max_steps", str(budget),
            "--loader_seed", str((args.loader_seed if args.loader_seed
                                  is not None else args.seed) + 9973 * seg)]
        print(f"— segment {seg}: steps {start} -> {budget} —", flush=True)
        rc = subprocess.call(child)
        end = latest_step()
        if end <= start:
            raise SystemExit(
                f"segment {seg} made no checkpoint progress (rc={rc}, "
                f"still at step {end}); aborting instead of looping")
        if rc != 0:
            print(f"segment {seg} exited rc={rc} but advanced "
                  f"{start} -> {end}; continuing", flush=True)
        seg += 1


def init_from_env(device: str = "cuda") -> str:
    """Join the process group of a torchrun world from its ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK``: NCCL on ``cuda:LOCAL_RANK``, or gloo
    where ``device`` is "cpu"; returns this process's device."""
    from dvd_tpu_torch.parallel.mesh import init_distributed

    if device == "cuda":
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    init_distributed("nccl" if device.startswith("cuda") else "gloo",
                     device, rank=int(os.environ["RANK"]),
                     world_size=int(os.environ["WORLD_SIZE"]))
    return device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train_module", default="dvd")
    ap.add_argument("--train_name", default="train_TDiff")
    ap.add_argument("--name", default="default")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--set", action="append", dest="overrides", metavar="K=V")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="generate an N-sample synthetic Doc3D-format "
                         "dataset (data.data_root/synthetic or "
                         "checkpoints/synthetic_doc3d) and train on it "
                         "through the standard loader path")
    ap.add_argument("--multihost", action="store_true",
                    help="one process of a torchrun world: join the "
                         "process group from RANK, WORLD_SIZE and "
                         "LOCAL_RANK (NCCL on cuda:LOCAL_RANK; gloo with "
                         "--device cpu)")
    ap.add_argument("--loader_seed", type=int, default=None,
                    help="epoch-order/augmentation seed for the data "
                         "loader only (default: --seed); lets resumed "
                         "segments draw fresh epoch orders without "
                         "touching the train step's random draws")
    ap.add_argument("--segment_steps", type=int, default=0, metavar="K",
                    help="run training as a chain of child processes of "
                         "at most K steps each, resuming from the latest "
                         "checkpoint between segments (requires "
                         "--max_steps)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "twins of the kernels)")
    args = ap.parse_args(argv)
    if args.segment_steps:
        return _run_segments(ap, args)
    device = init_from_env(args.device) if args.multihost else args.device
    try:
        _train_main(args, device)
    finally:
        if args.multihost:
            dist.destroy_process_group()


def _train_main(args, device: str) -> None:
    from dvd_tpu_torch.cli.run_sampling import parse_overrides
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.parallel.mesh import make_mesh
    from dvd_tpu_torch.training.train_loop import train

    over = parse_overrides(args.overrides)
    if args.data_root:
        over.setdefault("data", {})["data_root"] = args.data_root
    over.setdefault("train", {}).setdefault("seed", args.seed)
    cfg = dataclasses.replace(default_config().replace(**over),
                              name=args.name)
    if args.synthetic:
        from dvd_tpu_torch.data.doc_npz import write_synthetic_doc_npz
        from dvd_tpu_torch.data.synthetic import write_synthetic_doc3d

        # never into a real dataset root: its sample list globs every
        # sample dir, so syn_* dirs beside real Doc3D samples would join
        # later real training runs
        root = (os.path.join(cfg.data.data_root, "synthetic")
                if cfg.data.data_root else "checkpoints/synthetic_doc3d")
        # every process writes the same seeded files; rank 0 alone, then
        # the others wait for them
        if not dist.is_initialized() or dist.get_rank() == 0:
            if cfg.data.dataset_name == "doc3d":
                write_synthetic_doc3d(root, args.synthetic, seed=args.seed)
            else:
                write_synthetic_doc_npz(root, args.synthetic, seed=args.seed)
        if dist.is_initialized():
            dist.barrier()
        cfg = cfg.replace(data={"data_root": root})
    if not cfg.train.on_device_aug and cfg.train.slim_wire:
        print("train.slim_wire is a JAX-package option: the port feeds the "
              "float wire", flush=True)
    mesh = make_mesh(cfg.parallel.data_axis, cfg.parallel.model_axis)
    loader = data_iterator(cfg, args.loader_seed if args.loader_seed
                           is not None else args.seed, device, mesh)
    # the loader emits the key set its dataset's flag asks for, and
    # train() tells the two kinds apart by their keys
    train(cfg, iter(loader), max_steps=args.max_steps, device=device,
          mesh=mesh)


if __name__ == "__main__":
    main()
