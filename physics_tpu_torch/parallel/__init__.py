"""Multi-rank stepping over torch.distributed (physics_tpu/parallel)."""
