"""dvd_tpu_torch -- the PyTorch/CUDA port of ``dvd_tpu``.

Serves and trains the same document-dewarping model (coordinate diffusion
over a 64x64 backward-map field, conditioned on segmentation, text-line
and image features) with PyTorch modules and hand-written Hopper kernels.
The JAX package ``dvd_tpu`` stays the reference; every ported module is
tested against it on the CPU (``tests/test_torch_*.py``).

Layout mirrors ``dvd_tpu``:

- ``config``      the port's own copy of ``dvd_tpu.config`` (the same
  dataclasses, flag names and defaults)
- ``ops``         resize, grid_sample and ``warp_const_src``; ``ops.kernels``
  wraps the CUDA kernels in ``csrc/`` (K1 attention, K2 conv3x3, K3
  bilinear gather and the fused unwarp built on it, K4 its coordinate
  gradient, K5 the exact integer 2-D gather), each beside its plain
  PyTorch twin, with autograd Functions for the training path
- ``diffusion``   schedule tables, DDIM step, the sampling loop, the
  training rollout and losses
- ``models``      DiT-S/2 + SATRN decoder, U2NetP/Seg, GeoTr mask branch,
  text-line UNet (NCHW; state_dict keys follow the flax parameter paths)
- ``evaluation``  ``DewarpPipeline``, ``unwarp_fixed`` and
  ``unwarp_native``; the batched dataset driver ``run_benchmark``
- ``data``        ``BenchmarkDataset``: pages of any size on one canvas
- ``training``    the train state and step (AdamW, clip, EMA, samplers),
  the training loop ``train_loop.train``, checkpoints and flax
  ``.msgpack`` weight files, the converter of the reference's torch
  checkpoints, and the flax-variables <-> state_dict bridge
- ``utils``       coordinate grids, the key-value logger, flax's msgpack
  format without flax
- ``cli``         ``run_sampling`` (``--image``, ``--eval_dataset``) and
  ``convert_ckpt``
- ``tools``       ``gather_probe``, the K5 probe

Importing this package imports ``torch`` and never ``jax`` or any module
of ``dvd_tpu``.
"""

__version__ = "0.1.0"
