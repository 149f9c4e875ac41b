"""Mesh-based SDF data: the pysdf/trimesh-free analog of the reference's
SDFDataset (ngp-ours/sdf/provider.py:28-88).

Port of ``flnerf_tpu/data/mesh_sdf.py``:
  * the OBJ / ASCII-PLY loaders and ``normalize_mesh`` (center + 0.95 * 2 /
    diag scale, provider.py:38-43), in numpy as the reference has them;
  * ``MeshSDF``: the signed distance to a triangle mesh in torch on the
    given device (default the card; with none it raises): the exact
    point-triangle distance (region decomposition, all selects, over
    [chunk, F] pairs) and the sign of the generalized winding number (a sum
    of signed solid angles, van Oosterom & Strackee), + inside as pysdf.
    The reference computes these as jitted plain JAX outside any kernel, so
    they stay plain torch here;
  * ``sample_surface`` and ``SDFMeshDataset.sample_batch``, in numpy, in the
    reference's draw order: 7/8 surface points (the latter 3/8 perturbed by
    a 0.01 gaussian) + 1/8 uniform in [-1, 1]^3, the sdf evaluated for the
    latter half only and stored as -pysdf (outside positive).
"""

from __future__ import annotations

import numpy as np
import torch

from flnerf_tpu_torch.core.device import resolve_device


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------

def load_obj(path: str):
    """ASCII OBJ -> (verts [V,3] f32, faces [F,3] i32); polygons are
    fan-triangulated; v/vt/vn index forms accepted."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) for t in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def load_ply_ascii(path: str):
    """ASCII PLY -> (verts, faces). Binary PLY is not supported here —
    convert offline (the reference route via trimesh is likewise an
    import-time conversion)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = [l for l in header if l.startswith("format")][0].split()[1]
        if fmt != "ascii":
            raise ValueError("binary PLY unsupported; convert to ascii "
                             "or OBJ")
        counts = {}
        order = []
        for l in header:
            if l.startswith("element"):
                _, name, cnt = l.split()
                counts[name] = int(cnt)
                order.append(name)
        body = f.read().decode("ascii", "replace").split("\n")
    rows = [r for r in body if r.strip()]
    # walk the body in the header's declared element order — a PLY may
    # legally declare `element face` before `element vertex`
    offsets, off = {}, 0
    for name in order:
        offsets[name] = off
        off += counts[name]
    nv = counts.get("vertex", 0)
    v0 = offsets.get("vertex", 0)
    verts = np.asarray(
        [[float(t) for t in rows[v0 + i].split()[:3]] for i in range(nv)],
        np.float32)
    faces = []
    f0 = offsets.get("face", nv)
    for i in range(counts.get("face", 0)):
        t = rows[f0 + i].split()
        k = int(t[0])
        idx = [int(v) for v in t[1:1 + k]]
        for j in range(1, k - 1):
            faces.append([idx[0], idx[j], idx[j + 1]])
    return verts, np.asarray(faces, np.int32)


def load_mesh(path: str):
    if path.endswith(".obj"):
        return load_obj(path)
    if path.endswith(".ply"):
        return load_ply_ascii(path)
    raise ValueError(f"unsupported mesh format: {path}")


def normalize_mesh(verts: np.ndarray) -> np.ndarray:
    """Reference normalization (provider.py:38-43): center the AABB and
    scale by 0.95 * 2 / diag so the mesh sits inside [-1, 1]."""
    vmin, vmax = verts.min(0), verts.max(0)
    center = (vmin + vmax) / 2
    scale = 2.0 / np.sqrt(np.sum((vmax - vmin) ** 2)) * 0.95
    return ((verts - center[None]) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Signed distance
# ---------------------------------------------------------------------------

class MeshSDF:
    """pysdf.SDF analog: sdf(points) > 0 INSIDE (pysdf convention; the
    dataset negates it for the instant-sdf sign, provider.py:75)."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray, chunk: int = 4096,
                 device="cuda"):
        self.device = resolve_device(device)
        self.verts = np.ascontiguousarray(verts, np.float32)
        self.faces = np.ascontiguousarray(faces, np.int32)
        self.chunk = chunk
        tri = self.verts[self.faces]                    # [F, 3, 3]
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        self._area = 0.5 * np.linalg.norm(n, axis=-1)
        self._tri = torch.from_numpy(tri).to(self.device)
        self._a = self._tri[:, 0]
        self._e0 = self._tri[:, 1] - self._tri[:, 0]    # b - a
        self._e1 = self._tri[:, 2] - self._tri[:, 0]    # c - a

    def _point_tri_d2(self, p: torch.Tensor) -> torch.Tensor:
        """[n, F] squared distances: the interior projection where the
        barycentric projection lands inside, else the least of the three
        clamped edge segments (exact in every region, all selects)."""
        a, e0, e1 = self._a, self._e0, self._e1
        d = p[:, None] - a[None]                        # [n, F, 3]
        aa = torch.sum(e0 * e0, -1)[None]
        bb = torch.sum(e0 * e1, -1)[None]
        cc = torch.sum(e1 * e1, -1)[None]
        dd = torch.sum(e0[None] * d, -1)
        ee = torch.sum(e1[None] * d, -1)

        det = torch.clamp(aa * cc - bb * bb, min=1e-30)
        s = (cc * dd - bb * ee) / det
        t = (aa * ee - bb * dd) / det
        inside = (s >= 0) & (t >= 0) & (s + t <= 1)

        def seg_d2(base, e, ee2):
            u = torch.clamp(torch.sum(e * base, -1) / torch.clamp(ee2, min=1e-30), 0.0, 1.0)
            q = base - u[..., None] * e
            return torch.sum(q * q, -1)

        e2 = e1 - e0                                    # c - b
        d2_edges = torch.minimum(
            torch.minimum(seg_d2(d, e0[None], aa), seg_d2(d, e1[None], cc)),
            seg_d2(d - e0[None], e2[None], torch.sum(e2 * e2, -1)[None]))
        q_in = d - s[..., None] * e0[None] - t[..., None] * e1[None]
        d2_in = torch.sum(q_in * q_in, -1)
        return torch.where(inside, d2_in, d2_edges)

    def _winding(self, p: torch.Tensor) -> torch.Tensor:
        """Generalized winding number [n] via signed solid angles."""
        r = self._tri[None] - p[:, None, None]          # [n, F, 3, 3]
        ra, rb, rc = r[:, :, 0], r[:, :, 1], r[:, :, 2]
        la = torch.linalg.norm(ra, dim=-1)
        lb = torch.linalg.norm(rb, dim=-1)
        lc = torch.linalg.norm(rc, dim=-1)
        num = torch.sum(ra * torch.linalg.cross(rb, rc, dim=-1), -1)
        den = (la * lb * lc + torch.sum(ra * rb, -1) * lc
               + torch.sum(rb * rc, -1) * la + torch.sum(rc * ra, -1) * lb)
        omega = 2.0 * torch.atan2(num, den)
        return torch.sum(omega, dim=1) / (4.0 * np.pi)

    @torch.no_grad()
    def query(self, p: torch.Tensor) -> torch.Tensor:
        """Signed distances [n] of points p [n, 3] on the mesh's device."""
        ud = torch.sqrt(torch.amin(self._point_tri_d2(p), dim=1))
        return torch.where(self._winding(p) > 0.5, ud, -ud)      # + inside

    def __call__(self, points: np.ndarray) -> np.ndarray:
        points = torch.from_numpy(np.asarray(points, np.float32).reshape(-1, 3)).to(self.device)
        out = [self.query(points[i:i + self.chunk])
               for i in range(0, points.shape[0], self.chunk)]
        return torch.cat(out, 0).cpu().numpy()

    # -- trimesh .sample analog ----------------------------------------
    def sample_surface(self, n: int, rng: np.random.Generator):
        probs = self._area / max(self._area.sum(), 1e-30)
        fi = rng.choice(self.faces.shape[0], size=n, p=probs)
        tri = self.verts[self.faces[fi]]
        u = rng.random((n, 1), dtype=np.float32)
        v = rng.random((n, 1), dtype=np.float32)
        flip = (u + v) > 1.0
        u = np.where(flip, 1.0 - u, u)
        v = np.where(flip, 1.0 - v, v)
        return (tri[:, 0] + u * (tri[:, 1] - tri[:, 0])
                + v * (tri[:, 2] - tri[:, 0])).astype(np.float32)


class SDFMeshDataset:
    """SDFDataset analog (provider.py:28): normalizes the mesh, then each
    batch is 7/8 surface points (the latter 3/8 perturbed by a 0.01
    gaussian) + 1/8 uniform in [-1, 1]^3; the sdf is 0 for the exact
    surface half and -pysdf (outside positive) for the rest."""

    def __init__(self, path: str, num_samples: int = 2 ** 18,
                 clip_sdf: float = None, seed: int = 0, device="cuda"):
        assert num_samples % 8 == 0, "num_samples must be divisible by 8"
        verts, faces = load_mesh(path)
        verts = normalize_mesh(verts)
        self.sdf_fn = MeshSDF(verts, faces, device=device)
        self.num_samples = num_samples
        self.clip_sdf = clip_sdf
        self.rng = np.random.default_rng(seed)

    def sample_batch(self):
        n = self.num_samples
        sdfs = np.zeros((n, 1), np.float32)
        surf = self.sdf_fn.sample_surface(n * 7 // 8, self.rng)
        surf[n // 2:] += 0.01 * self.rng.standard_normal(
            (n * 7 // 8 - n // 2, 3)).astype(np.float32)
        unif = (self.rng.random((n // 8, 3), dtype=np.float32) * 2 - 1)
        pts = np.concatenate([surf, unif], 0).astype(np.float32)
        sdfs[n // 2:] = -self.sdf_fn(pts[n // 2:])[:, None]
        if self.clip_sdf is not None:
            sdfs = sdfs.clip(-self.clip_sdf, self.clip_sdf)
        return pts, sdfs
