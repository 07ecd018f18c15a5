"""Typed configuration: the ``dvd_tpu`` flag set, as the port's own copy.

The same frozen dataclasses, field names and defaults as
``dvd_tpu/config.py`` (reference ``admin/local.py`` flag names), with
``replace``/``to_dict``/``to_json``/``from_dict``, so a config written
for one package reads the same in the other.  The port keeps its own copy
so that it never imports the JAX package, not even this pure-Python
module; ``tests/test_torch_train_ops.py`` checks that the two copies stay
field-for-field equal.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple, Union


@dataclass(frozen=True)
class DiffusionConfig:
    """Diffusion process flags (reference ``admin/local.py:35,66-81``)."""

    diffusion_steps: int = 3
    noise_schedule: str = "cosine"            # "linear" | "cosine"
    timestep_respacing: str = ""              # "" | "ddimN" | "a,b,c"
    predict_xstart: bool = True
    rescale_timesteps: bool = True
    learn_sigma: bool = False
    sigma_small: bool = False
    use_kl: bool = False
    rescale_learned_sigmas: bool = True
    clip_denoised: bool = False
    # sampling
    n_batch: int = 2                          # number of hypotheses averaged
    eta: float = 0.0
    use_ddim: bool = False                    # reference local.py:76 (the
    # dewarping sampler is always the DDIM-style loop; flag kept for parity)
    num_samples: int = 10000                  # generic-sampler count (:74)


@dataclass(frozen=True)
class ModelConfig:
    """Denoiser + conditioning flags.

    ``train_mode`` selects the denoiser family exactly like the reference
    factory (``script_util.py:93-203``):
      - ``stage_1_dit_cross`` : DiT-S/2 w/ parallel cross-attn (production)
      - ``stage_1_dit_cat``   : same DiT family
      - ``stage_1``           : UNet denoiser (68-ch input)
      - ``stage_1_transformer``: pure-transformer denoiser
      - ``stage_1_doctr``     : GeoTr2 (DocTr-as-denoiser)
    """

    train_mode: str = "stage_1_dit_cross"
    dit_variant: str = "DiT-S/2"
    image_size: int = 64                      # latent flow-field resolution
    source_size: int = 512                    # conditioning image resolution
    perception_size: int = 288                # aux-net input resolution
    in_channels: int = 2
    iter: bool = True                         # per-step source re-warp branch
    time_variant: bool = True                 # recurrent init_flow/init_feat
    # Intentional deviation switch (default OFF = reference behavior):
    # the reference's training rollout calls the model at *rescaled*
    # timesteps (667/333 — gaussian_diffusion.py:731-733 mode='train'
    # skips the cross_model.py:575-579 remap) while serving remaps to
    # raw t {2,1,0}; the regimes only become behaviorally consistent at
    # reference-scale budgets (docs/E2E_DEMO.md pins the small-budget
    # divergence).  ON: the rollout remaps like serving, making training
    # recurrence-consistent with inference from step one.  Must stay OFF
    # when training weights meant to match reference checkpoints.
    remap_rollout_timesteps: bool = False
    train_VGG: bool = True                    # use DiT's private pyramid
    use_gt_mask: bool = False                 # False -> use seg-net pyramid
    use_line_mask: bool = True
    use_init_flow: bool = False
    separate_cross_attn: str = "para"         # "para" | "seq" | "one"
    # Reference quirk: the DiT forward loop never feeds one block's output
    # into the next (cross_model.py:615-616) so only the LAST block
    # contributes.  ``chain_blocks=False`` reproduces that (and lets us skip
    # the dead blocks at inference); True gives a sane chained DiT for
    # from-scratch training, served and benchmarked at DiT-XL/2
    # (perfbench/configs/dvd-ditxl2-chain-serve.json).
    chain_blocks: bool = False
    # UNet-denoiser knobs (reference local.py:57-72)
    num_channels: int = 128
    num_res_blocks: int = 3
    num_heads: int = 4
    num_heads_upsample: int = -1
    attention_resolutions: str = "16,8"
    dropout: float = 0.0
    use_scale_shift_norm: bool = True
    use_checkpoint: bool = False
    use_sr_net: bool = False                  # reference local.py:84 (the
    # 'sr' UNet refinement stage; off in the shipped config)
    class_cond: bool = False                  # improved-diffusion flag (:65)
    # dtype policy
    compute_dtype: str = "bfloat16"           # "float32" | "bfloat16"
    param_dtype: str = "float32"
    # dynamic-int8 matmuls in the DiT blocks + SATRN decoder at serving
    # time ("int8"); serving-only and default-off (not ported yet)
    quantize: str = "none"                    # "none" | "int8"
    # serve the conditioning aux nets in sub-batches of this size (a JAX
    # package option; 0 = monolithic, the only value the port takes)
    serve_cond_chunk: int = 0
    # the JAX package's planar-layout switch for the aux nets; the port is
    # NCHW throughout and reads no value of it
    planar_aux: str = "auto"                  # "auto" | "on" | "off"

    @property
    def flow_size(self) -> Tuple[int, int]:
        """Reference ``flow_size=(64,64)`` (local.py:56) — derived."""
        return (self.image_size, self.image_size)


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop flags (reference ``admin/local.py:34-55``)."""

    lr: float = 1e-4
    batch_size: int = 10                      # per-host batch
    microbatch: int = -1
    weight_decay: float = 0.0
    lr_anneal_steps: int = 0
    # single rate or comma-separated list ("0.9999,0.999"); the reference
    # keeps one EMA param copy + checkpoint file per rate
    # (train_util.py:70-80, 599-624)
    ema_rate: Union[float, str] = 0.9999
    grad_clip: float = 1.0
    schedule_sampler: str = "uniform"         # "uniform" | "loss-second-moment"
    log_interval: int = 20
    save_interval: int = 4000
    resume_checkpoint: Optional[str] = None
    resume_step: int = 0
    initial_pretrained_model: Optional[str] = None  # reference local.py:50
    use_fp16: bool = False                    # torch-era flag; see compute_dtype
    fp16_scale_growth: float = 1e-3
    seed: int = 0
    # run the 512^2 intermediate warp + color jitter on the device in the
    # batch prep (data/device_aug.py) instead of in host loader workers
    # (the reference's cv2/kornia worker augmentation,
    # listdataset.py:573-703)
    on_device_aug: bool = True
    # with on_device_aug, keep a small dataset on the device and gather
    # batches there.  "auto": when single-process and it fits the GB cap;
    # "on": required; "off": host loader
    device_dataset: str = "auto"              # "auto" | "on" | "off"
    device_dataset_max_gb: float = 4.0
    # uint8/latent-res host->device wire for train batches (a JAX package
    # option; the port always feeds the float wire)
    slim_wire: bool = True

    @property
    def ema_rates(self) -> Tuple[float, ...]:
        """Parsed EMA rate list (reference train_util.py:76-80).  Accepts
        a float, a "0.9999,0.999" string, or a tuple/list (the --set CLI
        override literal-evals comma values to a tuple)."""
        if isinstance(self.ema_rate, str):
            return tuple(float(x) for x in self.ema_rate.split(",") if x)
        if isinstance(self.ema_rate, (tuple, list)):
            return tuple(float(x) for x in self.ema_rate)
        return (float(self.ema_rate),)


@dataclass(frozen=True)
class DataConfig:
    """Dataset roots & eval-set selection (reference ``local.py:8-33``)."""

    dataset_name: str = "doc3d"
    data_root: str = ""                       # = reference 'doc_debug' root
    data_dir: str = ""                        # improved-diffusion alias (:51)
    texture_list: str = ""                    # bg-texture list file (the
    # reference hard-codes an absolute path, listdataset.py:565-571)
    eval_dataset_name: str = "docunet"        # docunet|dir300|anyphoto|docreal
    eval_dataset: str = ""
    n_threads: int = 4
    val_batch_size: int = 1
    # intermediate-warp interpolation step t/T (the reference hard-codes
    # t=0, listdataset.py:625); also consumed by the on-device-aug path
    inter_t: int = 0
    inter_T: int = 20
    # per-device serving batch (the reference loops bs=1; we batch)
    eval_device_batch: int = 4


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh layout.  The reference is pure data-parallel DDP
    (``dist_util.py:21-72``); we map that to a ``data`` mesh axis and add an
    optional ``model`` axis for tensor-parallel attention/MLP shards."""

    data_axis: int = -1                       # -1 -> all remaining devices
    model_axis: int = 1
    fsdp: bool = False                        # shard params over data axis


@dataclass(frozen=True)
class PathsConfig:
    """Checkpoint paths (reference ``local.py:77-80``)."""

    workspace_dir: str = "checkpoints"
    tensorboard_dir: str = "checkpoints"      # reference local.py:4
    model_path: str = "checkpoints/model1852000.npz"
    seg_model_path: str = "checkpoints/seg.npz"
    line_seg_model_path: str = "checkpoints/line_model2.npz"
    new_seg_model_path: str = "checkpoints/seg_model.npz"


@dataclass(frozen=True)
class DvDConfig:
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    name: str = "default"
    visualize: bool = True

    def replace(self, **sections: Mapping[str, Any]) -> "DvDConfig":
        """Return a copy with per-section field overrides.

        ``cfg.replace(model={"iter": False}, train={"lr": 3e-4})``
        """
        updates = {}
        for sec, over in sections.items():
            cur = getattr(self, sec)
            if dataclasses.is_dataclass(cur) and isinstance(over, Mapping):
                updates[sec] = dataclasses.replace(cur, **over)
            else:
                updates[sec] = over
        return dataclasses.replace(self, **updates)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DvDConfig":
        kwargs: dict = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if dataclasses.is_dataclass(f.type) or f.name in (
                "diffusion", "model", "train", "data", "parallel", "paths"
            ):
                sub_cls = {
                    "diffusion": DiffusionConfig,
                    "model": ModelConfig,
                    "train": TrainConfig,
                    "data": DataConfig,
                    "parallel": ParallelConfig,
                    "paths": PathsConfig,
                }[f.name]
                kwargs[f.name] = sub_cls(**v)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)


def default_config() -> DvDConfig:
    """The production configuration shipped by the reference
    (``train_mode='stage_1_dit_cross'``, iter/time_variant on, T=3)."""
    return DvDConfig()
