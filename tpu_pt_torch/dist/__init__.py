"""Distribution: tile-sharded renders and the sharded gradient step on
``torch.distributed`` (NCCL between CUDA ranks, gloo on the CPU and for
ranks that share one card)."""
