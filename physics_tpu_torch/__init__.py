"""physics_tpu_torch — the PyTorch + CUDA port of physics_tpu.

The JAX package (physics_tpu/) is the reference; this package imports
torch and never jax. Ported so far: the 4,096-body box pile's step
(scenes.box_pile under scenes.pile_config) through three hand-written
Hopper kernels — the sweep-window masks (Triton, ops/sweep_kernel.py),
the contact table (CUDA, csrc/contact_table.cu) and the banded solve
(CUDA, csrc/banded_solve.cu). Each kernel wrapper runs its plain PyTorch
version on CPU tensors and launches the kernel on CUDA tensors.
"""

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.state import SimState

__all__ = ["SimConfig", "SimState"]
