"""Padded per-class mesh banks (numpy): the port's copy of
scflow_tpu/render/meshbank.py.

All classes pad to a common (V, F); padding faces are (0, 0, 0) with
face_valid False, padding vertices sit at the origin with vert_valid False.
"""

import os
import warnings
from dataclasses import dataclass
from glob import glob
from typing import List, Optional, Sequence

import numpy as np

from scflow_tpu_torch.render.ply import PlyMesh, load_ply

SYNTHETIC_KINDS = ("cube", "uvsphere", "sphere")


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
    class_names: Optional[Sequence[str]] = None

    @property
    def num_class(self) -> int:
        return self.verts.shape[0]

    @classmethod
    def from_meshes(cls, meshes: List[PlyMesh], pad_multiple: int = 8,
                    class_names=None, diameters=None) -> "MeshBank":
        vmax = _round_up(max(len(m.vertices) for m in meshes), pad_multiple)
        fmax = _round_up(max(len(m.faces) for m in meshes), pad_multiple)
        c = len(meshes)
        verts = np.zeros((c, vmax, 3), np.float32)
        faces = np.zeros((c, fmax, 3), np.int32)
        colors = np.full((c, vmax, 3), 0.7, np.float32)
        normals = np.zeros((c, vmax, 3), np.float32)
        vert_valid = np.zeros((c, vmax), bool)
        face_valid = np.zeros((c, fmax), bool)
        diams = np.zeros((c,), np.float32)
        for i, m in enumerate(meshes):
            nv, nf = len(m.vertices), len(m.faces)
            verts[i, :nv] = m.vertices
            faces[i, :nf] = m.faces
            if m.colors is not None:
                colors[i, :nv] = m.colors
            normals[i, :nv] = (m.normals if m.normals is not None
                               else m.compute_vertex_normals())
            vert_valid[i, :nv] = True
            face_valid[i, :nf] = True
            diams[i] = diameters[i] if diameters is not None else m.diameter
        return cls(verts, faces, colors, normals, vert_valid, face_valid, diams,
                   class_names)

    @classmethod
    def from_dir(cls, mesh_dir: str, ext: str = ".ply", pad_multiple: int = 8,
                 diameters=None) -> "MeshBank":
        """Load the `ext` meshes of a directory (or one file) sorted by path;
        a class's label is its place in that order."""
        if os.path.isdir(mesh_dir):
            paths = sorted(glob(os.path.join(mesh_dir, "*" + ext)))
        else:
            paths = [mesh_dir]
        if not paths:
            raise FileNotFoundError(f"no {ext} meshes under {mesh_dir}")
        names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        return cls.from_meshes([load_ply(p) for p in paths], pad_multiple,
                               class_names=names, diameters=diameters)

    def subsample(self, max_verts: int, seed: int = 0) -> "MeshBank":
        """A bank of at most max_verts vertices per class, drawn without
        replacement from a seeded numpy generator (the same draw as the JAX
        package's), for the losses; its faces are one invalid face."""
        rng = np.random.default_rng(seed)
        c, v, _ = self.verts.shape
        if v <= max_verts:
            return self
        verts = np.zeros((c, max_verts, 3), np.float32)
        valid = np.zeros((c, max_verts), bool)
        for i in range(c):
            n = int(self.vert_valid[i].sum())
            take = min(n, max_verts)
            idx = rng.choice(n, size=take, replace=False)
            verts[i, :take] = self.verts[i, idx]
            valid[i, :take] = True
        return MeshBank(verts, np.zeros((c, 1, 3), np.int32), np.zeros_like(verts),
                        np.zeros_like(verts), valid, np.zeros((c, 1), bool), self.diameters,
                        self.class_names)

    def closed_consistently_wound(self) -> np.ndarray:
        """(C,) bool: is each class a closed 2-manifold wound outward, so
        that backface culling cannot drop visible geometry?  Every directed
        edge appears once and its reverse also appears (after welding
        vertices at exactly equal positions, so scan seams still pair), no
        welded face is degenerate, and the signed volume is positive."""
        out = []
        for i in range(self.num_class):
            f = self.faces[i][self.face_valid[i]].astype(np.int64)
            if len(f) == 0:
                out.append(False)
                continue
            uverts, canon = np.unique(self.verts[i], axis=0, return_inverse=True)
            f = canon.reshape(-1)[f]
            if ((f[:, 0] == f[:, 1]) | (f[:, 1] == f[:, 2]) | (f[:, 2] == f[:, 0])).any():
                out.append(False)
                continue
            edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
            vmax = int(edges.max()) + 1
            keys = edges[:, 0] * vmax + edges[:, 1]
            rkeys = edges[:, 1] * vmax + edges[:, 0]
            closed = len(np.unique(keys)) == len(keys) and bool(np.isin(rkeys, keys).all())
            tri = uverts[f]  # (F, 3, 3)
            vol = np.einsum("fi,fi->f", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() / 6.0
            out.append(closed and vol > 0)
        return np.asarray(out, bool)


def resolve_cull_backfaces(bank: MeshBank, setting) -> bool:
    """A `cull_backfaces` setting behind the winding check: falsy turns
    culling off; True turns it on when every class passes
    `closed_consistently_wound` and raises ValueError otherwise; 'force'
    turns it on regardless, with a warning for failing classes.  Either way
    the camera must stay outside the mesh and the mesh in front of the near
    plane, which the mesh alone cannot show."""
    if not setting:
        return False
    ok = bank.closed_consistently_wound()
    if ok.all():
        return True
    bad = [i for i, v in enumerate(ok) if not v]
    msg = (f"cull_backfaces enabled but mesh classes {bad} are not closed "
           "consistently-outward-wound manifolds: culling would drop visible "
           "geometry for them. Disable cull_backfaces, fix the meshes, or set "
           "cull_backfaces='force' if you know these meshes are safe.")
    if setting == "force":
        warnings.warn(msg)
        return True
    raise ValueError(msg)


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


def make_synthetic_bank(num_class: int = 3, kind: str = "cube",
                        size: float = 60.0, subdivisions: int = 0) -> MeshBank:
    """Synthetic coloured meshes for tests and benchmarks.  kind='cube' is
    a 12-face cube, 'sphere' a subdivided octahedron (8 * 4**subdivisions
    faces; `subdivisions` also splits the cube), 'uvsphere' exactly 1024
    faces and ignores `subdivisions`."""
    if kind not in SYNTHETIC_KINDS:
        raise ValueError(f"unsupported synthetic mesh kind {kind!r}; "
                         f"expected one of {SYNTHETIC_KINDS}")
    meshes = []
    for c in range(num_class):
        s = size * (1.0 + 0.3 * c)
        if kind == "uvsphere":
            v, f = _uv_sphere(s / 2.0, rings=17, segments=32)
        elif kind == "cube":
            v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
                         np.float32) / 2.0
            f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                          [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                          [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
        else:
            v = np.array([[s, 0, 0], [-s, 0, 0], [0, s, 0], [0, -s, 0], [0, 0, s],
                          [0, 0, -s]], np.float32) / 2.0
            f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                          [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
        for _ in range(subdivisions if kind != "uvsphere" else 0):
            v, f = _subdivide(v, f)
            if kind != "cube":  # keep spheres spherical
                v = v / np.linalg.norm(v, axis=-1, keepdims=True) * (s / 2)
        colors = (v - v.min(0)) / (v.max(0) - v.min(0) + 1e-9)
        m = PlyMesh(v, f, colors=colors.astype(np.float32))
        m.normals = m.compute_vertex_normals()
        meshes.append(m)
    return MeshBank.from_meshes(meshes)
