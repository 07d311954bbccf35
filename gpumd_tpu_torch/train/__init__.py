"""The NEP trainers: batched structures, the batched forward and loss,
SNES and the gnep Adam step (counterpart of gpumd_tpu/train)."""
