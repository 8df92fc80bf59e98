"""The benchmark of physics_tpu_torch on one NVIDIA GPU (run.py)."""
