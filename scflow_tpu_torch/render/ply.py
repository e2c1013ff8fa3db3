"""Minimal PLY mesh loader (numpy, no external deps): the port's own copy of
scflow_tpu/render/ply.py, which the port may not import.

Replaces trimesh / pytorch3d PLY IO used by the reference
(models/utils/rendering.py:63-67, datasets/pose.py:9-16).  Supports ascii and
binary_little_endian, vertex properties (x y z [nx ny nz] [red green blue
[alpha]]) and triangular faces; quads are fan-triangulated.
"""

from typing import Dict

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class PlyMesh:
    def __init__(self, vertices, faces, colors=None, normals=None, uv=None):
        self.vertices = vertices  # (V, 3) float32
        self.faces = faces  # (F, 3) int32
        self.colors = colors  # (V, 3) float32 in [0, 1] or None
        self.normals = normals  # (V, 3) float32 or None
        self.uv = uv

    @property
    def diameter(self) -> float:
        """Max pairwise vertex distance (mesh diameter, used by ADD metrics)."""
        v = self.vertices
        # exact O(V^2) is fine for eval meshes; chunk to bound memory
        best = 0.0
        step = 1024
        for i in range(0, len(v), step):
            d = np.linalg.norm(v[i : i + step, None] - v[None], axis=-1)
            best = max(best, float(d.max()))
        return best

    def compute_vertex_normals(self) -> np.ndarray:
        v, f = self.vertices, self.faces
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        n = np.zeros_like(v)
        for k in range(3):
            np.add.at(n, f[:, k], fn)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        return (n / np.maximum(norm, 1e-12)).astype(np.float32)


def _parse_header(fh):
    line = fh.readline().decode("ascii").strip()
    if line != "ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # list of (name, count, [(prop_kind, ...)])
    while True:
        line = fh.readline().decode("ascii").strip()
        if line == "end_header":
            break
        parts = line.split()
        if not parts or parts[0] == "comment" or parts[0] == "obj_info":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", _PLY_DTYPES[parts[2]], _PLY_DTYPES[parts[3]], parts[4]))
            else:
                elements[-1][2].append(("scalar", _PLY_DTYPES[parts[1]], parts[2]))
    return fmt, elements


def load_ply(path: str) -> PlyMesh:
    with open(path, "rb") as fh:
        fmt, elements = _parse_header(fh)
        data: Dict[str, Dict[str, np.ndarray]] = {}
        if fmt == "ascii":
            for name, count, props in elements:
                rows = {p[-1]: [] for p in props}
                face_lists = []
                for _ in range(count):
                    vals = fh.readline().split()
                    i = 0
                    for p in props:
                        if p[0] == "list":
                            n = int(vals[i]); i += 1
                            face_lists.append([float(x) for x in vals[i : i + n]])
                            i += n
                        else:
                            rows[p[-1]].append(float(vals[i])); i += 1
                data[name] = {k: np.asarray(v) for k, v in rows.items() if v}
                if face_lists:
                    data[name]["_lists"] = face_lists
        elif fmt == "binary_little_endian":
            for name, count, props in elements:
                if all(p[0] == "scalar" for p in props):
                    dtype = np.dtype([(p[-1], "<" + p[1]) for p in props])
                    arr = np.frombuffer(fh.read(dtype.itemsize * count), dtype=dtype)
                    data[name] = {p[-1]: arr[p[-1]] for p in props}
                else:
                    # mixed/list properties: per-row parse (faces)
                    face_lists = []
                    scalars = {p[-1]: [] for p in props if p[0] == "scalar"}
                    for _ in range(count):
                        for p in props:
                            if p[0] == "list":
                                cnt_dt = np.dtype("<" + p[1])
                                n = int(np.frombuffer(fh.read(cnt_dt.itemsize), cnt_dt)[0])
                                val_dt = np.dtype("<" + p[2])
                                vals = np.frombuffer(fh.read(val_dt.itemsize * n), val_dt)
                                face_lists.append(vals.tolist())
                            else:
                                dt = np.dtype("<" + p[1])
                                scalars[p[-1]].append(
                                    np.frombuffer(fh.read(dt.itemsize), dt)[0]
                                )
                    data[name] = {k: np.asarray(v) for k, v in scalars.items() if v}
                    if face_lists:
                        data[name]["_lists"] = face_lists
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    vert = data["vertex"]
    vertices = np.stack([vert["x"], vert["y"], vert["z"]], axis=-1).astype(np.float32)
    normals = None
    if "nx" in vert:
        normals = np.stack([vert["nx"], vert["ny"], vert["nz"]], axis=-1).astype(np.float32)
    colors = None
    if "red" in vert:
        colors = (
            np.stack([vert["red"], vert["green"], vert["blue"]], axis=-1).astype(np.float32)
            / 255.0
        )
    uv = None
    if "texture_u" in vert:
        uv = np.stack([vert["texture_u"], vert["texture_v"]], axis=-1).astype(np.float32)

    faces = []
    if "face" in data and "_lists" in data["face"]:
        for lst in data["face"]["_lists"]:
            idx = [int(x) for x in lst]
            for k in range(1, len(idx) - 1):  # fan triangulation
                faces.append([idx[0], idx[k], idx[k + 1]])
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    return PlyMesh(vertices, faces, colors=colors, normals=normals, uv=uv)
