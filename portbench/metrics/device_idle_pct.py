"""The share of the traced window in which no device operation runs
(device trace; moves train_rays_per_s, or train_rays_per_s.ngp as
device_idle_pct.ngp)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
