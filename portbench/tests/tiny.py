"""Small sizes of the cells, for runs on the CPU."""


def plenoxels(work: dict, cfg: dict) -> None:
    cfg["scene"] = {"H": 16, "W": 16, "n_train": 4, "n_test": 1}
    cfg["args"].update(reso="[[16, 16, 16]]", batch_size=64, steps_per_chunk=2)
    work["slice_rays"] = 128
    work["trace_seconds"] = 0.01


def ngp(work: dict, cfg: dict) -> None:
    cfg["scene"] = {"H": 16, "W": 16, "n_train": 20, "n_test": 1}
    # 16 full refreshes of 4-step chunks: the first partial one at step 64
    cfg["args"].update(num_rays=64, grid_size=16, n_candidates=32, n_keep=16, steps_per_chunk=4)
    work["warmup_steps"] = 64
    work["steps_per_call"] = 8
    work["trace_seconds"] = 0.01


def for_cell(cell: str):
    return plenoxels if cell.startswith("plenoxels") else ngp
