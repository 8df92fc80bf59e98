"""physics_tpu_torch — the PyTorch + CUDA port of physics_tpu.

The JAX package (physics_tpu/) is the reference; this package imports
torch and never jax. Ported so far: the box pile's step (scenes.box_pile
under scenes.pile_config, with or without the contact table), the hull
rains' step (scenes.mesh_rain and mesh_rain_mixed under
scenes.rain_config) and packed envs, on one process or row-sharded over
the ranks of a torch.distributed group (parallel/sharding.py), and the
generic hull path (scenes.rain_xla_config), through twelve hand-written
Hopper kernels: gravity and the velocity
integration (csrc/body_forces.cu), the sweep broad phase's masks and
bucketed candidates (csrc/sweep.cu), the geometry table
(csrc/geom_table.cu), the contact tables' operands (the previous keys'
columns, and a gated refresh's gate; csrc/table_prep.cu), the box and
hull contact tables (csrc/contact_table.cu,
csrc/hull_table.cu), the generic hull path's pair contacts
(csrc/hull_list.cu), the banded pair manifolds
(csrc/narrowphase_banded.cu) and four banded solve kernels
(csrc/banded_solve.cu); and joints (the four joint types, their CG in
one hand-written kernel, csrc/joint_cg.cu) with the reference's compat
mode, which steps its own scene, scene.demo_scene, under
config.compat_config. Each kernel wrapper runs its plain PyTorch
version on CPU tensors and launches the kernel on CUDA tensors. Scenes
are built on the card unless the caller passes device="cpu".
"""

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.state import SimState

__all__ = ["SimConfig", "SimState"]
