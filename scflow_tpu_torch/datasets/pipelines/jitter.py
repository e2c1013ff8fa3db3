"""Pose jitter of the train pipeline: gaussian rotation and translation
noise with rejection sampling under angle, translation and ADD caps.  The
port's copy of scflow_tpu/datasets/pipelines/jitter.py (reference
datasets/pipelines/jitter.py), drawing from numpy's global RNG in the same
order: the 1000-vertex subsets at construction, then per object and attempt
three euler angles and three translation draws.

As the JAX package's: the add_limit branch subsamples the vertices from
mesh_dir (the reference asserts on an unbound name), init_rot_error and
init_trans_error carry what their names say (the reference swaps them), and
when no attempt of max_attempts passes the caps the pose is returned
unjittered with zero errors."""

import glob
from os import path as osp

import numpy as np
from scipy.spatial.transform import Rotation

from scflow_tpu_torch.registry import PIPELINES
from scflow_tpu_torch.render.ply import load_ply


def rot_error_deg(r1: np.ndarray, r2: np.ndarray) -> float:
    """The angle in degrees of r2 r1^-1."""
    cos = (np.trace(r2 @ np.linalg.inv(r1)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


@PIPELINES.register_module("PoseJitter")
class PoseJitter:
    def __init__(self, jitter_angle_dis, jitter_x_dis, jitter_y_dis, jitter_z_dis,
                 jitter_pose_field, jittered_pose_field, add_limit=None,
                 translation_limit=None, angle_limit=None, mesh_dir=None,
                 mesh_diameter=None, max_attempts=200):
        self.angle_dis = jitter_angle_dis
        self.x_dis, self.y_dis, self.z_dis = jitter_x_dis, jitter_y_dis, jitter_z_dis
        self.src_field = jitter_pose_field
        self.dst_field = jittered_pose_field
        self.angle_limit = angle_limit
        self.translation_limit = translation_limit
        self.add_limit = add_limit
        self.max_attempts = max_attempts
        self.mesh_vertices = None
        if add_limit is not None:
            if mesh_dir is None or mesh_diameter is None:
                raise ValueError("PoseJitter with add_limit needs mesh_dir and mesh_diameter")
            verts = [load_ply(p).vertices for p in sorted(glob.glob(osp.join(mesh_dir, "*.ply")))]
            self.mesh_vertices = [v[np.random.choice(v.shape[0], 1000)] for v in verts]
            self.mesh_diameters = mesh_diameter

    def jitter(self, rotation, translation, label):
        """(jittered R, jittered t, ADD error / diameter, rotation error in
        degrees, translation error) of one object."""
        for _ in range(self.max_attempts):
            angle = np.random.normal(self.angle_dis[0], self.angle_dis[1], size=3)
            dR = Rotation.from_euler("zyx", angle, degrees=True).as_matrix().astype(np.float32)
            jr = dR @ rotation
            rot_err = rot_error_deg(rotation, jr)
            if self.angle_limit is not None and rot_err > self.angle_limit:
                continue
            noise = np.array([np.random.normal(self.x_dis[0], self.x_dis[1]),
                              np.random.normal(self.y_dis[0], self.y_dis[1]),
                              np.random.normal(self.z_dis[0], self.z_dis[1])], np.float32)
            trans_err = float(np.linalg.norm(noise))
            if self.translation_limit is not None and trans_err > self.translation_limit:
                continue
            jt = translation + noise
            add_err = 0.0
            if self.add_limit is not None:
                verts = self.mesh_vertices[label]
                gt_pts = (rotation @ verts.T + translation[:, None]).T
                ref_pts = (jr @ verts.T + jt[:, None]).T
                add_err = float(np.linalg.norm(gt_pts - ref_pts, axis=-1).mean()
                                / self.mesh_diameters[label])
                if add_err > self.add_limit:
                    continue
            return jr, jt, add_err, rot_err, trans_err
        return rotation.copy(), translation.copy(), 0.0, 0.0, 0.0

    def __call__(self, results):
        rotations = results[self.src_field[0]]
        translations = results[self.src_field[1]]
        out = [self.jitter(rotations[i], translations[i], results["labels"][i])
               for i in range(len(rotations))]
        results[self.dst_field[0]] = np.stack([o[0] for o in out])
        results[self.dst_field[1]] = np.stack([o[1] for o in out])
        for j, key in enumerate(("init_add_error", "init_rot_error", "init_trans_error")):
            results[key] = np.asarray([o[2 + j] for o in out], np.float32)
        return results
