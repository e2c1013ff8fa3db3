"""Padded per-class mesh banks (numpy).  Copy of the parts of
scflow_tpu/render/meshbank.py (and ply.py's vertex normals and diameter)
that the inference path and its tests use: `MeshBank` and
`make_synthetic_bank` for the 'uvsphere' and 'sphere' kinds.

All classes pad to a common (V, F); padding faces are (0, 0, 0) with
face_valid False, padding vertices sit at the origin with vert_valid False.
"""

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class MeshBank:
    verts: np.ndarray  # (C, V, 3) float32
    faces: np.ndarray  # (C, F, 3) int32
    colors: np.ndarray  # (C, V, 3) float32 in [0, 1]
    normals: np.ndarray  # (C, V, 3) float32
    vert_valid: np.ndarray  # (C, V) bool
    face_valid: np.ndarray  # (C, F) bool
    diameters: np.ndarray  # (C,) float32

    @property
    def num_class(self) -> int:
        return self.verts.shape[0]


def _vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(norm, 1e-12)).astype(np.float32)


def _diameter(v: np.ndarray) -> float:
    """Max pairwise vertex distance."""
    best = 0.0
    for i in range(0, len(v), 1024):
        best = max(best, float(np.linalg.norm(v[i:i + 1024, None] - v[None], axis=-1).max()))
    return best


def _bank(meshes: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
          pad_multiple: int = 8) -> MeshBank:
    vmax = _round_up(max(len(v) for v, _, _ in meshes), pad_multiple)
    fmax = _round_up(max(len(f) for _, f, _ in meshes), pad_multiple)
    c = len(meshes)
    verts = np.zeros((c, vmax, 3), np.float32)
    faces = np.zeros((c, fmax, 3), np.int32)
    colors = np.full((c, vmax, 3), 0.7, np.float32)
    normals = np.zeros((c, vmax, 3), np.float32)
    vert_valid = np.zeros((c, vmax), bool)
    face_valid = np.zeros((c, fmax), bool)
    diams = np.zeros((c,), np.float32)
    for i, (v, f, col) in enumerate(meshes):
        verts[i, :len(v)] = v
        faces[i, :len(f)] = f
        colors[i, :len(v)] = col
        normals[i, :len(v)] = _vertex_normals(v, f)
        vert_valid[i, :len(v)] = True
        face_valid[i, :len(f)] = True
        diams[i] = _diameter(v)
    return MeshBank(verts, faces, colors, normals, vert_valid, face_valid, diams)


def _subdivide(verts: np.ndarray, faces: np.ndarray):
    """One loop of midpoint subdivision (4x faces)."""
    edge_mid = {}
    verts = list(verts)

    def mid(a, b):
        key = (min(a, b), max(a, b))
        if key not in edge_mid:
            edge_mid[key] = len(verts)
            verts.append((np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0)
        return edge_mid[key]

    out = []
    for a, b, c in faces:
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return np.asarray(verts, np.float32), np.asarray(out, np.int32)


def _uv_sphere(radius: float, rings: int, segments: int):
    """Lat/long sphere with 2*segments*(rings-1) triangles (17 rings and 32
    segments give 1024, the face budget of the reference's render meshes)."""
    vs = [np.array([0.0, 0.0, radius], np.float32)]
    for i in range(1, rings):
        phi = np.pi * i / rings
        for j in range(segments):
            theta = 2.0 * np.pi * j / segments
            vs.append(np.array([
                radius * np.sin(phi) * np.cos(theta),
                radius * np.sin(phi) * np.sin(theta),
                radius * np.cos(phi)], np.float32))
    vs.append(np.array([0.0, 0.0, -radius], np.float32))
    v = np.stack(vs)
    last = len(vs) - 1
    f = []

    def ring0(i, j):
        return 1 + (i - 1) * segments + (j % segments)

    for j in range(segments):  # top cap
        f.append([0, ring0(1, j), ring0(1, j + 1)])
    for i in range(1, rings - 1):  # bands
        for j in range(segments):
            a, b = ring0(i, j), ring0(i, j + 1)
            c, d = ring0(i + 1, j), ring0(i + 1, j + 1)
            f.append([a, c, d])
            f.append([a, d, b])
    for j in range(segments):  # bottom cap
        f.append([last, ring0(rings - 1, j + 1), ring0(rings - 1, j)])
    return v, np.asarray(f, np.int32)


def make_synthetic_bank(num_class: int = 3, kind: str = "uvsphere",
                        size: float = 60.0, subdivisions: int = 0) -> MeshBank:
    """Synthetic coloured meshes for tests and benchmarks.  kind='uvsphere'
    has exactly 1024 faces per mesh; kind='sphere' is a subdivided
    octahedron with 8 * 4**subdivisions faces."""
    if kind not in ("uvsphere", "sphere"):
        raise ValueError(f"unsupported synthetic mesh kind {kind!r}")
    meshes = []
    for c in range(num_class):
        s = size * (1.0 + 0.3 * c)
        if kind == "uvsphere":
            v, f = _uv_sphere(s / 2.0, rings=17, segments=32)
        else:
            v = np.array(
                [[s, 0, 0], [-s, 0, 0], [0, s, 0], [0, -s, 0], [0, 0, s], [0, 0, -s]],
                np.float32,
            ) / 2.0
            f = np.array(
                [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                 [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]],
                np.int32,
            )
            for _ in range(subdivisions):
                v, f = _subdivide(v, f)
                v = v / np.linalg.norm(v, axis=-1, keepdims=True) * (s / 2)
        colors = (v - v.min(0)) / (v.max(0) - v.min(0) + 1e-9)
        meshes.append((v, f, colors.astype(np.float32)))
    return _bank(meshes)
