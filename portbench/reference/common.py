"""Helpers of the plain references: real spherical harmonics, the
readings a training check compares, and the precision a reference runs in.
Plain torch; imports nothing of the program."""

from __future__ import annotations

import statistics

import torch

# the standard real SH constants (svox2 utils.eval_sh_bases, torch-ngp shencoder)
C0 = 0.28209479177387814
C1 = 0.48860251190291987
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525251999,
      -1.0925484305920792, 0.54627421529603959)
C3 = (0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
      0.3731763325901154, 0.45704579946446572, 1.4453057213202769,
      0.59004358992664352)


def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """Unit directions [..., 3] -> [..., degree**2] real SH (degree <= 4)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, C0)]
    if degree > 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree > 2:
        x2, y2, z2 = x * x, y * y, z * z
        out += [C2[0] * x * y, C2[1] * y * z, 3.0 * C2[2] * z2 - C2[2],
                C2[3] * x * z, C2[4] * (x2 - y2)]
    if degree > 3:
        x2, y2, z2 = x * x, y * y, z * z
        out += [C3[0] * y * (-3.0 * x2 + y2), C3[1] * x * y * z,
                C3[2] * y * (1.0 - 5.0 * z2), C3[3] * z * (5.0 * z2 - 3.0),
                C3[4] * x * (1.0 - 5.0 * z2), C3[5] * z * (x2 - y2),
                C3[6] * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, -1)


def norms(tensors) -> list:
    """Frobenius norm of each tensor, as floats (in float64)."""
    return [float(torch.linalg.vector_norm(t.detach().double())) for t in tensors]


def training_gaps(prog: dict, ref: dict) -> dict:
    """The numbers a training check compares, from the program's and the
    reference's readings, each a dict of ``loss`` [steps], ``grad`` [leaves]
    (the first gradient's norms), ``change`` [leaves] (the norms of the
    parameters' change after the steps), and where both have them ``ema``
    [leaves] (the norms of the weights' EMA's change), ``leaf`` [steps] of
    [quadtree leaves] (the budget's per-leaf statistic, -inf for a leaf no
    ray reached) and ``refresh`` (the densities of an occupancy refresh's
    cells):

    - ``loss_gap``: the largest relative gap of a step's loss;
    - ``grad_gap``, ``change_gap`` and ``ema_gap``: over the leaves, the
      largest gap between the program's norm and the reference's, over the
      larger of the reference's norm of that leaf and of the median leaf.
      Leaves whose reference gradient is under a thousandth of the median
      leaf's move by round-off alone, and are left out of the changes;
    - ``leaf_gap``: over the steps, the largest gap of a quadtree leaf's
      statistic over the step's largest; infinite where the two differ in
      which leaves a ray reached;
    - ``refresh_gap``: the norm of the refreshed densities' difference over
      the norm of what the reference's refresh raised them by above their
      decay (``refresh_decayed``): most cells only decay, and the raise is
      where the field's own sigma enters; infinite where the reference
      raised none and the two differ."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))

    def worst(p, r, keep):
        med = statistics.median(r)
        return max(abs(a - b) / max(b, med, 1e-30)
                   for a, b, k in zip(p, r, keep) if k)

    g_med = statistics.median(ref["grad"])
    moved = [g >= 1e-3 * g_med for g in ref["grad"]]
    out = {"loss_gap": loss,
           "grad_gap": worst(prog["grad"], ref["grad"], [True] * len(ref["grad"])),
           "change_gap": worst(prog["change"], ref["change"], moved)}
    if "ema" in prog and "ema" in ref:
        out["ema_gap"] = worst(prog["ema"], ref["ema"], moved)
    if "leaf" in prog and "leaf" in ref:
        out["leaf_gap"] = max(leaf_gap(p, r) for p, r in zip(prog["leaf"], ref["leaf"]))
    if "refresh" in prog and "refresh" in ref:
        p, r = prog["refresh"].double(), ref["refresh"].double()
        gap = float(torch.linalg.vector_norm(p - r))
        raise_ = float(torch.linalg.vector_norm(r - ref["refresh_decayed"].double()))
        out["refresh_gap"] = gap / raise_ if raise_ > 0 else (0.0 if gap == 0 else float("inf"))
    return out


def leaf_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """One step's per-leaf statistics [leaves] (-inf: no ray): the largest
    gap over the largest reference statistic; inf where the two differ in
    which leaves a ray reached."""
    prog, ref = torch.as_tensor(prog).double(), torch.as_tensor(ref).double()
    seen = torch.isfinite(ref)
    if prog.shape != ref.shape or not torch.equal(seen, torch.isfinite(prog)):
        return float("inf")
    if not seen.any():
        return 0.0
    return float((prog[seen] - ref[seen]).abs().max() / ref[seen].abs().max().clamp(min=1e-30))
