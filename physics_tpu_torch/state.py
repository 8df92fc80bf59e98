"""Simulation state as dataclasses of tensors.

Field names, shapes and dtypes are those of physics_tpu/state.py
(`SimState`, `Joints`, `Shapes`, `HullSet`), so a state can cross between
the two packages as a dict of numpy arrays (`state_from_arrays`,
`to_numpy`). Nested fields are flattened with dotted names
("shapes.stype", "joints.body_a", ...).

Quaternions are (w, x, y, z).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

Tensor = torch.Tensor

# joint types (physics_tpu/state.py): rows a slot holds in brackets
JOINT_NONE = 0
JOINT_FIX_POINT = 1        # C = x_a − target                (3)
JOINT_FIX_ORIENTATION = 2  # C = euler(q_a) − target         (3)
JOINT_BALL = 3             # C = p_a(anchor) − p_b(anchor)   (3)
JOINT_DISTANCE = 4         # C = ‖d‖ − L                     (1)
MAX_JOINT_ROWS = 3

SHAPE_NONE = 0
SHAPE_SPHERE = 1
SHAPE_BOX = 2
SHAPE_HULL = 3


def _replace(self, **kw):
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Joints:
    """Fixed-capacity joint table ([J] / [J, 8]); slot j is live iff
    jtype[j] != JOINT_NONE. params: FIX_POINT [0:3] the world target;
    FIX_ORIENTATION [0:3] the target euler angles; BALL and DISTANCE
    [0:3], [3:6] the anchors in body a's and body b's frames, DISTANCE
    [6] the rest length. body_b −1 is the world."""

    jtype: Tensor
    body_a: Tensor
    body_b: Tensor
    params: Tensor
    ks: Tensor
    kd: Tensor

    replace = _replace

    @property
    def capacity(self) -> int:
        return self.jtype.shape[-1]


@dataclasses.dataclass
class Shapes:
    """Per-body collision geometry."""

    stype: Tensor        # [N] int32
    params: Tensor       # [N, 3] f32 (box half extents)
    hull_index: Tensor   # [N] int32
    friction: Tensor     # [N] f32
    restitution: Tensor  # [N] f32

    replace = _replace


@dataclasses.dataclass
class HullSet:
    """Convex-hull library [H, ...], padded to shared capacities (see
    scene._pack_hulls); the hull contact table reads it. Tables derived
    from it are kept on the object (`derived`)."""

    verts: Tensor
    vert_count: Tensor
    face_normals: Tensor
    face_offsets: Tensor
    face_count: Tensor
    face_verts: Tensor
    face_vert_count: Tensor
    edge_dirs: Tensor
    edge_dir_count: Tensor
    edge_i0: Tensor
    edge_i1: Tensor
    edge_count: Tensor

    replace = _replace

    def derived(self, key, build):
        """build(), kept on this object under `key` with the field tensors
        it was built from and their version counters. Each call checks
        both on the host (no device work) and builds again when a field
        was replaced or edited in place: the steps of one scene build the
        tables once, a captured step reads the kept tensors, and an
        edited library never reads stale ones (`replace` gives a new
        object, which keeps nothing)."""
        src = tuple(getattr(self, f.name) for f in dataclasses.fields(self))
        stamp = tuple(t._version for t in src)
        kept = self.__dict__.setdefault("_derived", {}).get(key)
        if kept is None or kept[1] != stamp or any(
                a is not b for a, b in zip(kept[0], src)):
            kept = self.__dict__["_derived"][key] = (src, stamp, build())
        return kept[2]

    def tables(self) -> list:
        """What derived() keeps now, a table a key. A captured CUDA graph
        keeps their addresses: whoever replays one holds these, since an
        edit of the library builds new tables and frees the old."""
        return [kept[2] for kept in self.__dict__.get("_derived", {}).values()]


@dataclasses.dataclass
class SimState:
    """Complete simulation state (see physics_tpu/state.py SimState).

    `step_count_host` mirrors `step_count` on the host, so the step can
    pick the anchored rebuild or refresh branch without a device sync.
    """

    pos: Tensor            # [N, 3]
    quat: Tensor           # [N, 4]
    vel: Tensor            # [N, 3]
    omega: Tensor          # [N, 3]
    force: Tensor          # [N, 3]
    torque: Tensor         # [N, 3]
    mass: Tensor           # [N]
    inv_mass: Tensor       # [N]
    inertia: Tensor        # [N, 3, 3]
    inv_inertia: Tensor    # [N, 3, 3]
    joints: Joints
    lam_joint: Tensor      # [J * 3]
    shapes: Shapes
    hulls: HullSet
    contact_key: Tensor    # [2, C] int32 (table paths)
    contact_lam: Tensor    # [3, C]
    contact_table: Tensor  # [32, C] or [0, 0]
    contact_order: Tensor  # [N] int32 or [0]
    contact_meta: Tensor   # [2] int32
    contact_ref: Tensor    # [N, 7] or [0, 0]
    step_count: Tensor     # [] int32
    step_count_host: int = 0

    replace = _replace

    @property
    def num_bodies(self) -> int:
        return self.pos.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.pos.device


_NESTED = {"joints": Joints, "shapes": Shapes, "hulls": HullSet}


def _empty_arrays(n: int) -> Dict[str, np.ndarray]:
    """Empty joints / hulls and the unprepared contact buffers, as
    physics_tpu.state.make_state fills them."""
    f32, i32 = np.float32, np.int32
    return {
        "joints.jtype": np.zeros((0,), i32),
        "joints.body_a": np.zeros((0,), i32),
        "joints.body_b": np.full((0,), -1, i32),
        "joints.params": np.zeros((0, 8), f32),
        "joints.ks": np.zeros((0,), f32),
        "joints.kd": np.zeros((0,), f32),
        "lam_joint": np.zeros((0,), f32),
        "hulls.verts": np.zeros((1, 1, 3), f32),
        "hulls.vert_count": np.zeros((1,), i32),
        "hulls.face_normals": np.zeros((1, 1, 3), f32),
        "hulls.face_offsets": np.zeros((1, 1), f32),
        "hulls.face_count": np.zeros((1,), i32),
        "hulls.face_verts": np.zeros((1, 1, 1), i32),
        "hulls.face_vert_count": np.zeros((1, 1), i32),
        "hulls.edge_dirs": np.zeros((1, 1, 3), f32),
        "hulls.edge_dir_count": np.zeros((1,), i32),
        "hulls.edge_i0": np.zeros((1, 1), i32),
        "hulls.edge_i1": np.zeros((1, 1), i32),
        "hulls.edge_count": np.zeros((1,), i32),
        "contact_key": np.zeros((0,), i32),
        "contact_lam": np.zeros((3, 0), f32),
        "contact_table": np.zeros((0, 0), f32),
        "contact_order": np.zeros((0,), i32),
        "contact_meta": np.zeros((2,), i32),
        "contact_ref": np.zeros((0, 0), f32),
        "step_count": np.zeros((), i32),
    }


def make_arrays(pos, quat, vel, omega, mass, inertia,
                shapes: Dict[str, np.ndarray],
                hulls: Dict[str, np.ndarray] | None = None,
                joints: Dict[str, np.ndarray] | None = None
                ) -> Dict[str, np.ndarray]:
    """Assemble the numpy arrays of a state (the numpy half of
    physics_tpu.state.make_state: inv_mass and inv_inertia with statics
    zeroed, the CG warm start lam_joint zero). `hulls` holds the HullSet
    fields (scene._pack_hulls), `joints` the Joints fields; None gives the
    empty one-entry library and the empty joint table."""
    pos = np.asarray(pos, np.float32)
    n = pos.shape[0]
    mass = np.asarray(mass, np.float32)
    inertia = np.asarray(inertia, np.float32)
    inv_mass = np.where(np.isinf(mass), 0.0, 1.0 / mass).astype(np.float32)
    safe = inertia.copy()
    safe[inv_mass == 0] = np.eye(3, dtype=np.float32)
    inv_inertia = np.where(
        (inv_mass > 0)[:, None, None],
        np.linalg.inv(safe).astype(np.float32),
        np.zeros((n, 3, 3), np.float32),
    )
    arrays = _empty_arrays(n)
    arrays.update({
        "pos": pos,
        "quat": np.asarray(quat, np.float32),
        "vel": np.asarray(vel, np.float32),
        "omega": np.asarray(omega, np.float32),
        "force": np.zeros((n, 3), np.float32),
        "torque": np.zeros((n, 3), np.float32),
        "mass": mass,
        "inv_mass": inv_mass,
        "inertia": inertia,
        "inv_inertia": inv_inertia,
    })
    arrays.update({f"shapes.{k}": v for k, v in shapes.items()})
    if hulls is not None:
        arrays.update({f"hulls.{k}": v for k, v in hulls.items()})
    if joints is not None:
        arrays.update({f"joints.{k}": v for k, v in joints.items()})
        arrays["lam_joint"] = np.zeros(
            (joints["jtype"].shape[0] * MAX_JOINT_ROWS,), np.float32)
    return arrays


_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32}


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point builds on. The default of every entry
    point is "cuda": without a CUDA device that raises, and the caller
    must ask for the CPU explicitly (device="cpu"); nothing falls back to
    the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: physics_tpu_torch builds scenes on the card by "
            "default; pass device='cpu' to run on the CPU")
    return dev


def state_from_arrays(arrays: Dict[str, np.ndarray],
                      device: torch.device | str = "cuda") -> SimState:
    """Build a SimState from a flat dict of numpy arrays keyed by field
    name (dotted for the nested structs), e.g. the fields of a JAX state
    passed through np.asarray. Every field is f32 or int32; all of them
    travel to `device` (the card by default, see resolve_device) in ONE
    copy of a packed byte buffer."""
    device = resolve_device(device)
    keys = sorted(arrays)
    arrs = [np.asarray(arrays[k]) for k in keys]
    offs, total = [], 0
    for a in arrs:
        if a.dtype not in _DTYPES:
            raise TypeError(f"state field of dtype {a.dtype}: f32/int32 only")
        offs.append(total)
        total += -(-a.nbytes // 16) * 16
    packed = np.zeros((max(total, 16),), np.uint8)
    for a, o in zip(arrs, offs):
        packed[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = torch.from_numpy(packed).to(device)
    nested: Dict[str, Dict[str, Tensor]] = {k: {} for k in _NESTED}
    top: Dict[str, object] = {}
    for key, a, o in zip(keys, arrs, offs):
        t = buf[o:o + a.nbytes].view(_DTYPES[a.dtype]).reshape(a.shape)
        if "." in key:
            head, field = key.split(".", 1)
            nested[head][field] = t
        else:
            top[key] = t
    for head, cls in _NESTED.items():
        top[head] = cls(**nested[head])
    # a batched state's counter is [E] (envs.py): env 0's
    top["step_count_host"] = int(np.asarray(arrays["step_count"]).flat[0])
    return SimState(**top)


def to_numpy(state: SimState) -> Dict[str, np.ndarray]:
    """The flat dict of numpy arrays that `state_from_arrays` reads."""
    out: Dict[str, np.ndarray] = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if f.name in _NESTED:
            for g in dataclasses.fields(val):
                out[f"{f.name}.{g.name}"] = (
                    getattr(val, g.name).detach().cpu().numpy())
        elif isinstance(val, Tensor):
            out[f.name] = val.detach().cpu().numpy()
    return out
