"""Host wall time inside the ray budget's calls (the budgeter's gen_rays and
adjust, the NGP sampler's sample_chunk and update_error_map) over the
window's steps, from the harness's spans around them (moves
train_rays_per_s.ngp).  Nothing when the window made no such call."""


def read(ctx):
    spans = [t for name, ts in ctx["spans"].items() if name.startswith("portbench.raygen.")
             for t in ts]
    if not spans or not ctx["window"]["steps"]:
        return None
    return 1e3 * sum(spans) / ctx["window"]["steps"]
