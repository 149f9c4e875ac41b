"""flnerf_tpu_torch — the PyTorch and CUDA port of ``flnerf_tpu`` for one
NVIDIA H100 (Hopper, sm_90a).

The package mirrors ``flnerf_tpu``'s subpackage layout and module names;
each module's docstring names the module it ports.  It imports torch, numpy
and scipy only, never JAX and nothing of ``flnerf_tpu``.

Ported so far: quadtree-budgeted Plenoxels training (``cli/opt.py``), with
the fused cuvol render forward and backward as CUDA kernels
(``ops/voxel_kernel.py``, ``ops/csrc/voxel_cuvol.cu``).

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; with no card present they raise instead of falling back.
"""

__version__ = "0.1.0"
