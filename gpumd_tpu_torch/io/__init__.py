"""Input files: extended XYZ and nep.in (counterpart of gpumd_tpu/io)."""
