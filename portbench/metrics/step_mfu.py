"""The whole training step's share of the chip's roofline: the mean least
time of the traced window's steps on their counted work (roofline.py) over
the measured wall time per step of the untraced window (host clock; moves
train_rays_per_s, or train_rays_per_s.ngp as step_mfu.ngp)."""


def read(ctx):
    work, win = ctx["work"], ctx["window"]
    if work is None or not work.get("step", {}).get("launches") or not win["steps"]:
        return None
    least = work["step"]["least_s"] / work["step"]["launches"]
    return 100.0 * least / (win["seconds"] / win["steps"])
