"""gpumd_tpu_torch: the PyTorch + CUDA (Hopper) port of the gpumd_tpu package.

Module paths mirror the JAX package (`gpumd_tpu/`), which stays the
reference: `gpumd_tpu_torch/engine/nep_compact.py` is the counterpart of
`gpumd_tpu/engine/nep_compact.py`, and so on.  This package imports torch and
never jax.  Its hand-written Hopper kernels live in `csrc/` and are built
with nvcc at first use (see `engine/cuda_build.py`).
"""
