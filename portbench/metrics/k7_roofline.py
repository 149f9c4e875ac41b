"""K7's share of its roofline (device trace; moves train_rays_per_s.ngp)."""

from portbench.kernel_share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k7", ("tile_bwd_kernel", "LatticeGeo"))
