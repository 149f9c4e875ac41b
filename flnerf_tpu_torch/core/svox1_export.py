"""PlenOctree (svox 1 N3Tree) export of a voxel grid.

Parity target: svox2.SparseGrid.to_svox1 (svox2/svox2.py:1635-1681) +
opt/to_svox1.py.  The reference calls into the ``svox`` package; that
package is not a dependency, so this module builds the N3Tree topology
directly and writes svox's npz checkpoint layout (keys: data_dim,
data_format, invradius3, offset, child, data), loadable by
``svox.N3Tree.load``.

Port of ``flnerf_tpu/core/svox1_export.py`` (numpy; the npz keys and arrays
equal the reference's bit for bit).  ``build_octree`` links each level's new
nodes in one vectorised assignment where the reference loops over them in
Python, so a 128^3 grid exports in seconds.

Topology matches the reference construction: starting from a depth-0
root, the paths of all occupied voxels are refined log2(reso)-1 times, so
occupied leaves sit at the voxel level and empty space collapses high up.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def build_octree(occ_coords: np.ndarray, reso: int):
    """Sparse binary-branching (N=2) octree over occupied voxel coords.

    Returns (child [n, 2, 2, 2] int32 relative pointers, leaf_node
    [M] int32, leaf_cell [M] int32): occupied voxel i lives at
    data[leaf_node[i], z, y, x...] — cell index = its last path step.
    """
    depth = int(np.log2(reso))
    if 2 ** depth != reso:
        raise ValueError(f"grid must be cubic power-of-2, not {reso}")
    m = occ_coords.shape[0]

    # path key per level: the (x, y, z) bits from MSB down; a level's new
    # nodes get ids in the order of their sorted keys (parent * 8 + cell)
    links = []                               # per level: (parent, cell, new id)
    n_nodes = 1
    node_of = np.zeros(m, np.int64)          # current node per voxel
    for d in range(depth - 1):
        shift = depth - 1 - d
        bits = (occ_coords >> shift) & 1                    # [M, 3]
        cell = (bits[:, 0] << 2) | (bits[:, 1] << 1) | bits[:, 2]
        key = node_of * 8 + cell
        uniq, inv = np.unique(key, return_inverse=True)
        new_ids = n_nodes + np.arange(len(uniq))
        links.append((uniq // 8, uniq % 8, new_ids))
        n_nodes += len(uniq)
        node_of = new_ids[inv.reshape(-1)]

    children = np.zeros((n_nodes, 2, 2, 2), np.int32)
    for parent, c, new_ids in links:
        children[parent, (c >> 2) & 1, (c >> 1) & 1, c & 1] = new_ids - parent

    bits = occ_coords & 1
    leaf_cell = (bits[:, 0] << 2) | (bits[:, 1] << 1) | bits[:, 2]
    return children, node_of.astype(np.int32), leaf_cell.astype(np.int32)


def save_svox1_npz(
    path: str,
    density: np.ndarray,      # [R, R, R]
    sh: np.ndarray,           # [R, R, R, 3*basis]
    alive: np.ndarray,        # [R, R, R] bool
    radius: Tuple[float, float, float],
    center: Tuple[float, float, float],
    basis_dim: int = 9,
) -> dict:
    """Write the svox N3Tree npz (SH{basis} format, data = [sh..., sigma])."""
    reso = density.shape[0]
    occ = np.argwhere(alive).astype(np.int64)                 # [M, 3]
    child, leaf_node, leaf_cell = build_octree(occ, reso)
    n = child.shape[0]
    data_dim = 3 * basis_dim + 1
    data = np.zeros((n, 2, 2, 2, data_dim), np.float16)
    cx, cy, cz = (leaf_cell >> 2) & 1, (leaf_cell >> 1) & 1, leaf_cell & 1
    data[leaf_node, cx, cy, cz, :-1] = sh[occ[:, 0], occ[:, 1], occ[:, 2]]
    data[leaf_node, cx, cy, cz, -1] = density[occ[:, 0], occ[:, 1], occ[:, 2]]

    radius = np.asarray(radius, np.float32)
    center = np.asarray(center, np.float32)
    invradius3 = 0.5 / radius
    offset = 0.5 - center * invradius3
    out = dict(
        data_dim=np.int64(data_dim),
        data_format=f"SH{basis_dim}",
        invradius3=invradius3,
        offset=offset.astype(np.float32),
        child=child,
        data=data,
    )
    np.savez_compressed(path, **out)
    return out


def lookup_octree(tree: dict, coord: np.ndarray, reso: int) -> np.ndarray:
    """Walk the exported tree to a voxel's leaf data (test helper)."""
    depth = int(np.log2(reso))
    node = 0
    for d in range(depth):
        shift = depth - 1 - d
        cx, cy, cz = ((int(coord[a]) >> shift) & 1 for a in range(3))
        rel = tree["child"][node, cx, cy, cz]
        if rel == 0:
            return tree["data"][node, cx, cy, cz]
        node = node + int(rel)
    raise AssertionError("walked past leaf level")
