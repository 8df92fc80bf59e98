"""physics_tpu_torch — the PyTorch + CUDA port of physics_tpu.

The JAX package (physics_tpu/) is the reference; this package imports
torch and never jax. Ported so far: the box pile's step (scenes.box_pile
under scenes.pile_config) and the hull rains' step (scenes.mesh_rain and
mesh_rain_mixed under scenes.rain_config), through four hand-written
Hopper kernels — the sweep-window masks (Triton, ops/sweep_kernel.py),
the box contact table (CUDA, csrc/contact_table.cu), the hull contact
table (CUDA, csrc/hull_table.cu) and the banded solve (CUDA,
csrc/banded_solve.cu). Each kernel wrapper runs its plain PyTorch version
on CPU tensors and launches the kernel on CUDA tensors. Scenes are built
on the card unless the caller passes device="cpu".
"""

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.state import SimState

__all__ = ["SimConfig", "SimState"]
