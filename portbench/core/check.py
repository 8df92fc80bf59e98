"""Whether the timed path's output is correct: the plain reference
(portbench/reference) computes the same steps from the same inputs, and
the largest gaps between the program's outputs and the reference's are
held to the cell's limits (checks/<workload>.json).

The reference checks the program step by step, from the program's own
state before each step: the step is a discontinuous function of its
inputs (the sweep's sort, contact activity and the warm-start match by
bucket), so two correct implementations that differ in the last bit of
one sum part ways within a few steps, and a trajectory cannot be
compared. Two cases, each over `check_steps` steps and the last step of
every call they touch (whose gathered output is compared too):
  start   the first calls of set-up: step 0 from the scene the benchmark
          made, with nothing of the program's (its warm-up steps);
  sample  calls of the window drawn from the seed (the first starting on
          a scheduled rebuild), each step from the program's state
          before it, with the resets that ended the call before applied
          by the reference.
What a step carries to the next (the table, the rank order, the keys
and impulses of the warm start, the reference poses) is itself an
output compared where it is made. The numbers (the worst over both
cases):
  pose_gap_m    max over bodies of |Δpos|∞ + 2·|Δq|·r (r the box's
                circumradius, |Δq| sign-folded): how far any point of a
                box lies from where the reference puts it, in metres;
  vel_gap_m_s   max over bodies of |Δv|∞ + |Δω|∞·r, in m/s;
  lam_gap_Ns    max over contact slots of |Δλ| (the warm start carried);
  key_mismatch  contact slots whose feature keys differ (exact: 0).
The control is the reference with its state held in bfloat16 (rounded
before each step), judged by the f32 reference the same way. The
reference is the configuration's module under portbench/reference/."""

from __future__ import annotations

import torch

NUMBERS = ("pose_gap_m", "vel_gap_m_s", "lam_gap_Ns", "key_mismatch")


class Case:
    """The program's snapshots around the compared steps of some calls:
    `snaps[-1]` before the first call (None: the scene), then `snaps[g]`
    after step g of the case; `outs[g]` the output gathered at the end
    of the call whose last step is g (after its resets)."""

    def __init__(self, k0: int, steps_per_call: int, check_steps: int):
        s = steps_per_call
        self.k0, self.s = k0, s
        self.calls = -(-check_steps // s)
        self.compared = sorted(set(range(check_steps)) | {
            c * s + s - 1 for c in range(self.calls)})
        self.keep = set(self.compared) | {g - 1 for g in self.compared}
        self.snaps: dict = {}
        self.outs: dict = {}

    def last_call(self) -> int:
        return self.k0 + self.calls - 1


def on_device(snap: dict, dev) -> dict:
    return {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
            for k, v in snap.items()}


def gaps(pos, quat, vel, omega, rs) -> dict:
    """The body numbers of poses (and velocities, where given) against
    the reference's state."""
    r = torch.sqrt(torch.sum(rs.shapes.params ** 2, dim=1))
    dp = torch.amax(torch.abs(pos - rs.pos), dim=1)
    dq = torch.sqrt(torch.minimum(torch.sum((quat - rs.quat) ** 2, dim=1),
                                  torch.sum((quat + rs.quat) ** 2, dim=1)))
    out = {"pose_gap_m": dp + 2.0 * dq * r}
    if vel is not None:
        dv = torch.amax(torch.abs(vel - rs.vel), dim=1)
        dw = torch.amax(torch.abs(omega - rs.omega), dim=1)
        out["vel_gap_m_s"] = dv + dw * r
    return {k: _worst(v) for k, v in out.items()}


def _worst(v: torch.Tensor) -> float:
    """The largest entry, inf where any is not finite."""
    if not bool(torch.isfinite(v).all()):
        return float("inf")
    return float(v.max()) if v.numel() else 0.0


def state_gaps(snap: dict, rs) -> dict:
    """Every number of a program state after a step against the
    reference's (the contact numbers where the reference carries
    contacts)."""
    g = gaps(snap["pos"], snap["quat"], snap["vel"], snap["omega"], rs)
    if "contact_lam" in snap:
        g["lam_gap_Ns"] = _worst(torch.abs(snap["contact_lam"]
                                           - rs.contact_lam))
    if "contact_key" in snap:
        g["key_mismatch"] = float(
            (snap["contact_key"] != rs.contact_key).any(dim=0).sum())
    return g


def out_gaps(out: torch.Tensor, rs) -> dict:
    """The numbers of a call's gathered output (pos | quat [| vel |
    omega])."""
    vel = omega = None
    if out.shape[1] == 13:
        vel, omega = out[:, 7:10], out[:, 10:13]
    return gaps(out[:, 0:3], out[:, 3:7], vel, omega, rs)


def apply_resets(ref, rs, schedule, k: int):
    """rs with the resets at the end of call k applied by the reference
    module `ref`."""
    got = schedule.resets_of(k)
    if got is None or not len(got[0]):
        return rs
    idx, pos, quat = got
    dev = rs.device
    return ref.reset_bodies(rs, torch.as_tensor(idx, device=dev),
                            torch.as_tensor(pos, device=dev),
                            torch.as_tensor(quat, device=dev))


def _merge(worst: dict, g: dict) -> dict:
    return {k: max(worst.get(k, 0.0), g.get(k, 0.0)) for k in NUMBERS}


def compare(ref, base, cfg, schedule, cases, control: bool = False
            ) -> dict:
    """{number: worst value} over the compared steps of `cases`, the
    reference module `ref` starting from `base` (its state of the
    scene); with `control`, also the control's numbers under
    "control"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = base.device
    worst = {k: 0.0 for k in NUMBERS}
    cworst = dict(worst)
    for case in cases:
        for g in case.compared:
            prev = case.snaps[g - 1]
            rs = base if prev is None else ref.from_snapshot(
                base, on_device(prev, dev))
            if g > 0 and g % case.s == 0:
                rs = apply_resets(ref, rs, schedule,
                                  case.k0 + g // case.s - 1)
            want = ref.step(rs, cfg)
            worst = _merge(worst, state_gaps(on_device(case.snaps[g], dev),
                                             want))
            if g in case.outs:
                after = apply_resets(ref, want, schedule,
                                     case.k0 + g // case.s)
                worst = _merge(worst, out_gaps(case.outs[g].to(dev), after))
            if control:
                got = ref.step(ref.held_in(rs, torch.bfloat16), cfg)
                snap = {k: getattr(got, k) for k in ref.SNAPSHOT}
                cworst = _merge(cworst, state_gaps(snap, want))
    if control:
        worst["control"] = cworst
    return worst


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a missing or non-finite number
    fails)."""
    return all(k in numbers and numbers[k] <= limits[k] for k in limits)
