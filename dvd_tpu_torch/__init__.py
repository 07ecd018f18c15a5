"""dvd_tpu_torch -- the PyTorch/CUDA port of ``dvd_tpu``.

Serves the same document-dewarping model (coordinate diffusion over a
64x64 backward-map field, conditioned on segmentation, text-line and image
features) with PyTorch modules and hand-written Hopper kernels.  The JAX
package ``dvd_tpu`` stays the reference; every ported module is tested
against it on the CPU (``tests/test_torch_*.py``).

Layout mirrors ``dvd_tpu``:

- ``config``      re-export of ``dvd_tpu.config`` (pure Python, one set of
  flag names)
- ``utils``       coordinate grids
- ``ops``         resize, grid_sample; ``ops.kernels`` wraps the CUDA kernels
  in ``csrc/`` (K1 attention, K2 conv3x3, K3 bilinear gather), each beside
  its plain PyTorch twin
- ``diffusion``   schedule tables, DDIM step, the sampling loop
- ``models``      DiT-S/2 + SATRN decoder, U2NetP/Seg, GeoTr mask branch,
  text-line UNet (NCHW; state_dict keys follow the flax parameter paths)
- ``evaluation``  ``DewarpPipeline`` and ``unwarp_fixed``
- ``training``    the JAX-variables -> state_dict bridge
- ``cli``         ``python -m dvd_tpu_torch.cli.run_sampling --image ...``

Importing this package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
