"""K2's share of its roofline (device trace; moves train_rays_per_s)."""

from portbench.kernel_share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k2", ("cuvol_bwd_kernel",))
