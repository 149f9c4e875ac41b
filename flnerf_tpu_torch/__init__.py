"""flnerf_tpu_torch — the PyTorch and CUDA port of ``flnerf_tpu`` for one
NVIDIA H100 (Hopper, sm_90a).

The package mirrors ``flnerf_tpu``'s subpackage layout and module names;
each module's docstring names the module it ports.  It imports torch, numpy
and scipy only, never JAX and nothing of ``flnerf_tpu``.

Ported so far: quadtree-budgeted Plenoxels training (``cli/opt.py``), with
the fused cuvol render forward and backward as CUDA kernels
(``ops/voxel_kernel.py``, ``ops/csrc/voxel_cuvol.cu``); hash-NGP training
(``cli/main_nerf.py``) on the packed engine, with the hash encoding's
forward and table gradient as CUDA kernels (``ops/hash_kernel.py``,
``ops/csrc/hash_encode.cu``), and at 2^16 and more table entries on the
lattice engine, with its sort, forward and table gradient as CUDA kernels
(``ops/sort_kernel.py``, ``ops/hash_lattice.py``,
``ops/csrc/hash_lattice.cu``), or on the sorted engine (torch-ngp's xor
hash), with the same sort and its own forward and table gradient as CUDA
kernels (``ops/hash_sorted.py``, ``ops/csrc/hash_sorted.cu``).

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; with no card present they raise instead of falling back.
"""

__version__ = "0.1.0"
