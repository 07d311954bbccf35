from gpumd_tpu_torch.parallel.domain import ShardedMD, make_mesh  # noqa: F401
