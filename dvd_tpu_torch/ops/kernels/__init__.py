"""Hand-written Hopper kernels (``dvd_tpu_torch/csrc``) behind PyTorch
wrappers.  Each wrapper takes its plain twin (``*_ref``) for CPU tensors
and launches its kernel, or raises, for CUDA tensors; each counts its
launches in a ``launches`` attribute."""
