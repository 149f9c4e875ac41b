"""Iso-surface mesh extraction: marching tetrahedra and marching cubes
(vectorized numpy), and the OBJ / PLY writers.

A line-for-line copy of ``flnerf_tpu/ops/marching.py`` (host numpy; no
kernel of either package), so both packages give the same meshes bit for
bit.  Capability parity with nerf-ours/extract_mesh.py (PyMCubes marching
cubes over the sigma field) and ngp-ours save_mesh (nerf/utils.py:582-602):
marching tetrahedra splits each cube into 6 tetrahedra, a tet with k
corners above the iso level yields 1 or 2 triangles with vertices linearly
interpolated on the crossing edges (16 cases); marching cubes builds its
256-case table from the cube's face segments.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

# cube corner offsets (x, y, z); int32 — corner_pos for a 256^3 grid is
# [16M, 8, 3] and int64 doubled the single-core host's peak RSS
_CUBE = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.int32,
)

# 6 tetrahedra per cube (corner indices), a standard decomposition
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int64,
)

# tet edges as (corner a, corner b) index pairs within the tet
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)

# Derive all 16 tet cases programmatically instead of hand tables: for each
# inside-corner bitmask, collect the edges whose endpoints straddle the
# surface; 3 crossings form a triangle, 4 form a quad split into two.
def _build_cases():
    cases = []
    for mask in range(16):
        inside = [(mask >> i) & 1 for i in range(4)]
        cross = [
            e_idx
            for e_idx, (a, b) in enumerate(_TET_EDGES)
            if inside[a] != inside[b]
        ]
        if len(cross) == 0:
            cases.append([])
        elif len(cross) == 3:
            cases.append([tuple(cross)])
        elif len(cross) == 4:
            # order the quad so consecutive edges share a tet face, then fan
            e0 = cross[0]
            rest = cross[1:]
            def is_opposite_edge(e1, e2):
                s1 = set(_TET_EDGES[e1])
                s2 = set(_TET_EDGES[e2])
                return len(s1 & s2) == 0  # opposite edges share no corner
            # opposite edge of e0 is the one sharing no corner
            opp = [e for e in rest if is_opposite_edge(e0, e)][0]
            others = [e for e in rest if e != opp]
            quad = [e0, others[0], opp, others[1]]
            cases.append([(quad[0], quad[1], quad[2]), (quad[0], quad[2], quad[3])])
        else:
            raise AssertionError(mask)
    return cases


_CASES = _build_cases()


def marching_tetrahedra(
    field: np.ndarray, iso: float = 0.0, origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a [X, Y, Z] scalar field.

    Returns (vertices [V, 3] float32, triangles [T, 3] int64).  Convention:
    "inside" = field > iso (density above threshold).
    """
    field = np.asarray(field, np.float32)
    X, Y, Z = field.shape
    gx, gy, gz = np.meshgrid(
        np.arange(X - 1, dtype=np.int32), np.arange(Y - 1, dtype=np.int32),
        np.arange(Z - 1, dtype=np.int32), indexing="ij"
    )
    base = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)       # [C, 3]

    corner_pos = base[:, None, :] + _CUBE[None, :, :]                # [C, 8, 3]
    corner_val = field[
        corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]
    ]                                                                # [C, 8]

    verts_all = []
    tris_all = []
    v_count = 0
    for tet in _TETS:
        tv = corner_val[:, tet]                                      # [C, 4]
        tp = corner_pos[:, tet].astype(np.float32)                   # [C, 4, 3]
        inside = tv > iso
        mask = (
            inside[:, 0].astype(np.int64)
            | (inside[:, 1] << 1)
            | (inside[:, 2] << 2)
            | (inside[:, 3] << 3)
        )
        for case_mask in range(1, 15):
            tris = _CASES[case_mask]
            if not tris:
                continue
            sel = np.nonzero(mask == case_mask)[0]
            if sel.size == 0:
                continue
            # interpolated vertex on each crossing edge used by this case
            edge_ids = sorted({e for tri in tris for e in tri})
            edge_vert_idx = {}
            edge_pos = {}
            for e in edge_ids:
                a, b = _TET_EDGES[e]
                va, vb = tv[sel, a], tv[sel, b]
                t = (iso - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
                t = np.clip(t, 0.0, 1.0)[:, None]
                p = tp[sel, a] * (1 - t) + tp[sel, b] * t
                verts_all.append(p)
                edge_pos[e] = p
                edge_vert_idx[e] = v_count + np.arange(sel.size)
                v_count += sel.size
            # consistent OUTWARD winding (PyMCubes/save_mesh convention):
            # the case table alone gives arbitrary order (mask m and 15-m
            # share edge sets), so orient each triangle's normal from the
            # inside (field > iso) corners toward the outside ones —
            # otherwise ~half the faces point inward (signed volume ~ 0,
            # holes under backface culling)
            ins = [(case_mask >> i) & 1 for i in range(4)]
            ci = np.mean(tp[sel][:, [i for i in range(4) if ins[i]]], 1)
            co = np.mean(tp[sel][:, [i for i in range(4) if not ins[i]]], 1)
            out_dir = co - ci                                    # [S, 3]
            for tri in tris:
                p0, p1, p2 = (edge_pos[e] for e in tri)
                nrm = np.cross(p1 - p0, p2 - p0)
                flip = np.sum(nrm * out_dir, -1) < 0.0
                i0, i1, i2 = (edge_vert_idx[e] for e in tri)
                tris_all.append(np.stack(
                    [i0, np.where(flip, i2, i1), np.where(flip, i1, i2)],
                    -1))

    if not verts_all:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    verts = np.concatenate(verts_all, 0)
    tris = np.concatenate(tris_all, 0)
    verts = verts * np.asarray(spacing, np.float32) + np.asarray(origin, np.float32)
    return verts.astype(np.float32), tris.astype(np.int64)


def save_obj(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in tris:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


def save_ply(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(tris)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


# ---------------------------------------------------------------------------
# Marching CUBES (the reference's PyMCubes algorithm, table-driven)
# ---------------------------------------------------------------------------
# The classic 256-case table is DERIVED here rather than hand-typed: for
# each inside-corner mask, the iso-patch boundary on each cube face is
# the face's marching-squares contour (ambiguous faces resolved by the
# fixed "separate inside corners" rule — symmetric, so adjacent cubes
# always agree on their shared face), the crossing points then link into
# closed loops (every crossing edge lies on exactly 2 faces), and each
# loop is fan-triangulated with a winding oriented inside -> outside.
# This reproduces marching cubes' defining property the tetrahedra path
# can't: one welded vertex per crossing GRID edge and at most a few
# triangles per cube, i.e. the same meshes nerf-ours/extract_mesh.py
# gets from mcubes.marching_cubes (up to the ambiguous-case convention).

# the 12 cube edges as (corner a, corner b) with _CUBE's corner order
_CUBE_EDGES = np.array(
    [
        [0, 1], [1, 2], [2, 3], [3, 0],        # z = 0 ring
        [4, 5], [5, 6], [6, 7], [7, 4],        # z = 1 ring
        [0, 4], [1, 5], [2, 6], [3, 7],        # verticals
    ],
    np.int64,
)

# each cube edge as (origin-corner offset, axis) — the global-edge key
# that welds shared vertices between neighboring cubes
_EDGE_ORIGIN_AXIS = [
    ((0, 0, 0), 0), ((1, 0, 0), 1), ((0, 1, 0), 0), ((0, 0, 0), 1),
    ((0, 0, 1), 0), ((1, 0, 1), 1), ((0, 1, 1), 0), ((0, 0, 1), 1),
    ((0, 0, 0), 2), ((1, 0, 0), 2), ((1, 1, 0), 2), ((0, 1, 0), 2),
]

# faces: 4 cyclic corners + the edge index between consecutive corners
_FACES = [
    ([0, 1, 2, 3], [0, 1, 2, 3]),
    ([4, 5, 6, 7], [4, 5, 6, 7]),
    ([0, 1, 5, 4], [0, 9, 4, 8]),
    ([3, 2, 6, 7], [2, 10, 6, 11]),
    ([0, 3, 7, 4], [3, 11, 7, 8]),
    ([1, 2, 6, 5], [1, 10, 5, 9]),
]


def _mc_segments(mask):
    """Patch-boundary segments (pairs of crossing-edge ids) for one
    inside-corner mask, one face at a time (marching squares)."""
    inside = [(mask >> i) & 1 for i in range(8)]
    segs = []
    for corners, edges in _FACES:
        ins = [inside[c] for c in corners]
        cross = [e for i, e in enumerate(edges)
                 if ins[i] != ins[(i + 1) % 4]]
        if len(cross) == 2:
            segs.append(tuple(cross))
        elif len(cross) == 4:
            # ambiguous face (diagonal inside corners): separate the
            # INSIDE corners — pair each inside corner's two adjacent
            # crossing edges
            for i in range(4):
                if ins[i]:
                    segs.append((edges[(i - 1) % 4], edges[i]))
    return segs


def _mc_loops(segs):
    """Link segments into closed loops of crossing-edge ids."""
    adj = {}
    for a, b in segs:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    loops, seen = [], set()
    for start in sorted(adj):
        if start in seen:
            continue
        loop, prev, cur = [start], None, start
        seen.add(start)
        while True:
            nxts = [n for n in adj[cur] if n != prev]
            nxt = nxts[0] if nxts else adj[cur][0]
            if nxt == start:
                break
            loop.append(nxt)
            seen.add(nxt)
            prev, cur = cur, nxt
        loops.append(loop)
    return loops


@functools.lru_cache(maxsize=1)
def _mc_table():
    """[256, MAXT, 3] int8 triangle table (crossing-edge ids, -1 pad),
    windings oriented inside -> outside on midpoint geometry."""
    mids = 0.5 * (_CUBE[_CUBE_EDGES[:, 0]] + _CUBE[_CUBE_EDGES[:, 1]])
    tris_per_case = []
    for mask in range(256):
        inside = np.array([(mask >> i) & 1 for i in range(8)], bool)
        tris = []
        if 0 < mask < 255:
            ci = _CUBE[inside].mean(0)
            co = _CUBE[~inside].mean(0)
            out = co - ci
            for loop in _mc_loops(_mc_segments(mask)):
                # orient the whole loop by its Newell normal, then fan
                pts = mids[loop]
                n = np.zeros(3)
                for i in range(len(loop)):
                    a, b = pts[i], pts[(i + 1) % len(loop)]
                    n += np.cross(a, b)
                if float(n @ out) < 0.0:
                    loop = loop[::-1]
                for i in range(1, len(loop) - 1):
                    tris.append((loop[0], loop[i], loop[i + 1]))
        tris_per_case.append(tris)
    maxt = max(len(t) for t in tris_per_case)
    table = np.full((256, maxt, 3), -1, np.int8)
    for m, tris in enumerate(tris_per_case):
        for j, t in enumerate(tris):
            table[m, j] = t
    return table


def marching_cubes(
    field: np.ndarray, iso: float = 0.0, origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Classic marching cubes over a [X, Y, Z] field (PyMCubes analog,
    nerf-ours/extract_mesh.py: mcubes.marching_cubes(sigma, thresh)).

    Returns (vertices [V, 3] f32, triangles [T, 3] int64) with one
    WELDED vertex per crossing grid edge.  "Inside" = field > iso."""
    field = np.asarray(field, np.float32)
    X, Y, Z = field.shape
    inside = field > iso

    # one interpolated vertex per crossing grid edge, per axis
    vid = []            # per-axis [X, Y, Z] int64 vertex index (-1 = none)
    verts = []
    count = 0
    for ax in range(3):
        sl_a = [slice(None)] * 3
        sl_b = [slice(None)] * 3
        sl_a[ax] = slice(None, -1)
        sl_b[ax] = slice(1, None)
        va, vb = field[tuple(sl_a)], field[tuple(sl_b)]
        cross = inside[tuple(sl_a)] != inside[tuple(sl_b)]
        idx = np.full(field.shape, -1, np.int64)
        n = int(cross.sum())
        flat = np.full(cross.shape, -1, np.int64)
        flat[cross] = count + np.arange(n)
        idx[tuple(sl_a)] = flat
        base = np.stack(np.nonzero(cross), -1).astype(np.float32)
        fa, fb = va[cross], vb[cross]
        t = (iso - fa) / np.where(np.abs(fb - fa) < 1e-12, 1e-12, fb - fa)
        p = base.copy()
        p[:, ax] += np.clip(t, 0.0, 1.0)
        verts.append(p)
        vid.append(idx)
        count += n

    gx, gy, gz = np.meshgrid(
        np.arange(X - 1, dtype=np.int32), np.arange(Y - 1, dtype=np.int32),
        np.arange(Z - 1, dtype=np.int32), indexing="ij")
    base = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)        # [C, 3]
    cv = inside[base[:, 0, None] + _CUBE[None, :, 0],
                base[:, 1, None] + _CUBE[None, :, 1],
                base[:, 2, None] + _CUBE[None, :, 2]]                # [C, 8]
    case = (cv << np.arange(8, dtype=np.int64)[None]).sum(-1)        # [C]

    # per-cube global vertex id of each of the 12 edges
    edge_gid = np.empty((base.shape[0], 12), np.int64)
    for e, ((ox, oy, oz), ax) in enumerate(_EDGE_ORIGIN_AXIS):
        edge_gid[:, e] = vid[ax][base[:, 0] + ox, base[:, 1] + oy,
                                 base[:, 2] + oz]

    table = _mc_table()                                              # [256,M,3]
    tri_edges = table[case]                                          # [C, M, 3]
    valid = tri_edges[..., 0] >= 0                                   # [C, M]
    c_sel, t_sel = np.nonzero(valid)
    tris = edge_gid[c_sel[:, None], tri_edges[c_sel, t_sel]]         # [T, 3]

    if count == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    v = np.concatenate(verts, 0)
    v = v * np.asarray(spacing, np.float32) + np.asarray(origin, np.float32)
    return v.astype(np.float32), tris.astype(np.int64)
