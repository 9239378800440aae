"""Triangle-mesh accretion geometry with the Jiménez-Segura-Feito
segment-triangle intersection test (counterpart of
`gradus_tpu/geometry/meshes.py`; reference `src/geometry/meshes.jl` and
`src/geometry/intersections.jl:58-101`, JSF algorithm, Computational
Geometry 43 (2010) 474-492). The per-step line-element test is a
vectorised (rays × triangles) predicate over each chord of the step, which
the lockstep solver's ``segment_fn`` route runs. The file loaders parse on
the host with numpy.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gradus_tpu_torch.config import default_device
from gradus_tpu_torch.utils.linalg import spherical_to_cartesian

__all__ = ["jsf_segment_triangle", "MeshAccretionGeometry"]


def _cross(a, b):
    """a × b over the last axis of two broadcastable (..., 3) tensors."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(torch.broadcast_tensors(a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0), dim=-1)


def jsf_segment_triangle(q1, q2, v1, v2, v3, eps: float = 1e-8):
    """Branchless JSF: does segment q1→q2 cross triangle (v1, v2, v3)?

    One-sided (front-facing only), matching the reference
    (intersections.jl:58-101). Shapes broadcast: q (..., 3), v (..., 3).
    The reference's second cross product D × A is −(A × D) bit for bit,
    so its two projections are the negated ones of the first."""
    A = q1 - v3
    B = v1 - v3
    C = v2 - v3
    W1 = _cross(B, C)
    w = torch.sum(A * W1, dim=-1)
    D = q2 - v3
    s = torch.sum(D * W1, dim=-1)

    W2p = _cross(A, D)
    t_p = torch.sum(W2p * C, dim=-1)
    u_p = -torch.sum(W2p * B, dim=-1)
    hit_pos = (w > eps) & (s <= eps) & (t_p >= -eps) & (u_p >= -eps) & (w >= s + t_p + u_p)

    t_z, u_z = -t_p, -u_p  # with W2z = D × A
    hit_zero = (torch.abs(w) <= eps) & (s < -eps) & (t_z <= eps) & (u_z <= eps) & (-s <= t_z + u_z)
    return hit_pos | hit_zero


class MeshAccretionGeometry(nn.Module):
    """Triangle soup (T, 3, 3) in cartesian coordinates with a bounding box,
    registered buffers (on the card unless ``device`` says otherwise);
    ``proximity2`` is the squared distance from a chord's end within which
    a triangle's first vertex must lie for the triangle to be tested.

    Used through the solver's segment-hit event mode: rays end at the end
    of any step whose path crosses a triangle (reference semantics — the
    DiscreteCallback terminates at step end, meshes.jl:66-77)."""

    segment_based = True
    optically_thin = True

    def __init__(self, triangles, bbox_min, bbox_max, proximity2: float = 9.0, *, dtype=torch.float64, device=None):
        super().__init__()
        device = default_device(device)
        for name, value in (("triangles", triangles), ("bbox_min", bbox_min), ("bbox_max", bbox_max)):
            self.register_buffer(name, torch.as_tensor(value, dtype=dtype, device=device))
        self.proximity2 = float(proximity2)

    @staticmethod
    def from_triangles(triangles, *, dtype=torch.float64, device=None):
        tri = np.asarray(triangles.cpu() if torch.is_tensor(triangles) else triangles, dtype=np.float64)
        flat = tri.reshape(-1, 3)
        return MeshAccretionGeometry(tri, flat.min(axis=0), flat.max(axis=0), dtype=dtype, device=device)

    def inner_radius(self):
        return 0.0

    def segment_hit(self, xa4, xb4):
        """(..., 4) BL positions → bool: does the cartesian chord cross the
        mesh? With the reference's bounding-box and triangle-proximity
        prefilters (meshes.jl:52-77).

        It materialises (rays × triangles × 3) tensors for each chord:
        counted from the shapes of its intermediates, ~60–80 bytes a
        ray-triangle pair in f32, so 256² rays against 384 triangles hold
        ~1.5–2 GB of card memory a chord, and a 1024² render against 512
        triangles ~32–43 GB."""
        q1 = spherical_to_cartesian(xa4)
        q2 = spherical_to_cartesian(xb4)
        inbox = torch.all((q2 > self.bbox_min) & (q2 < self.bbox_max), dim=-1)
        v1, v2, v3 = self.triangles.unbind(-2)
        near = torch.sum((v1 - q2[..., None, :]) ** 2, dim=-1) < self.proximity2
        hits = jsf_segment_triangle(q1[..., None, :], q2[..., None, :], v1, v2, v3)
        return inbox & torch.any(hits & near, dim=-1)

    # --- mesh-file ingestion ----------------------------------------------
    # The reference loads meshes through GeometryBasics / FileIO
    # (`src/geometry/meshes.jl:4-30`). Here the two ubiquitous interchange
    # formats are parsed directly into the (T, 3, 3) triangle soup.

    @staticmethod
    def from_file(path, **kw):
        """Load a mesh by extension: .obj (ASCII) or .stl (ASCII/binary);
        ``kw`` (``dtype``, ``device``) goes to `from_triangles`."""
        p = str(path).lower()
        if p.endswith(".obj"):
            return MeshAccretionGeometry.from_obj(path, **kw)
        if p.endswith(".stl"):
            return MeshAccretionGeometry.from_stl(path, **kw)
        raise ValueError(f"unsupported mesh format: {path} (use .obj or .stl)")

    @staticmethod
    def from_obj(path, **kw):
        """Wavefront OBJ: `v x y z` vertices + `f i j k ...` faces (1-based,
        `i/uv/n` attribute syntax accepted); polygons are fan-triangulated."""
        verts = []
        faces = []
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "v":
                    verts.append([float(c) for c in parts[1:4]])
                elif parts[0] == "f":
                    idx = [int(tok.split("/")[0]) for tok in parts[1:]]
                    idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                    for k in range(1, len(idx) - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
        if not faces:
            raise ValueError(f"no faces found in OBJ file {path}")
        V = np.asarray(verts, dtype=float)
        F = np.asarray(faces, dtype=int)
        return MeshAccretionGeometry.from_triangles(V[F], **kw)

    @staticmethod
    def from_stl(path, **kw):
        """STL, either flavor. Binary: 80-byte header, uint32 count, then
        50-byte records (normal + 3 vertices + attribute). ASCII: `vertex`
        lines grouped in threes."""
        with open(path, "rb") as fh:
            raw = fh.read()
        is_ascii = raw[:6].strip().lower().startswith(b"solid")
        if is_ascii:
            # some binary files also start with "solid": verify by length
            n = np.frombuffer(raw[80:84], np.uint32)[0] if len(raw) >= 84 else -1
            if len(raw) == 84 + 50 * int(n):
                is_ascii = False
        if is_ascii:
            vs = []
            for line in raw.decode("ascii", errors="ignore").splitlines():
                parts = line.split()
                if parts and parts[0] == "vertex":
                    vs.append([float(c) for c in parts[1:4]])
            if len(vs) < 3:
                raise ValueError(f"no triangles found in STL file {path}")
            tri = np.asarray(vs, dtype=float)[: 3 * (len(vs) // 3)].reshape(-1, 3, 3)
        else:
            n = int(np.frombuffer(raw[80:84], np.uint32)[0])
            rec = np.frombuffer(raw[84 : 84 + 50 * n], dtype=np.uint8).reshape(n, 50)
            floats = rec[:, :48].copy().view(np.float32).reshape(n, 4, 3)
            tri = floats[:, 1:4].astype(float)  # drop the normal row
        return MeshAccretionGeometry.from_triangles(tri, **kw)
