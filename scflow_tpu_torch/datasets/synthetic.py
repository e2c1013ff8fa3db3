"""A synthetic on-disk BOP set: the layout of the JAX package's test helper
(tests/synthetic_bop.py), which its tools/bf16_parity.py trains and tests
on, written without cv2 (the card's machine has none).

build_synthetic_bop writes train_real/000001/{rgb,mask_visib,scene_*.json},
models_eval/ and models_1024/ (.ply), image_lists/train.txt,
keypoints.json and initial_poses/ (the ground truth jittered).  The
images are renders of the synthetic meshes at the ground-truth pose
(render_images=True) or noise with a filled disc per object as its mask;
the draws, the JSON files and the .ply bytes are the helper's."""

import json
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

from scflow_tpu_torch.datasets.pipelines.imops import fill_circle, imwrite
from scflow_tpu_torch.render.meshbank import make_synthetic_bank

IMG_HW = (120, 160)
K = np.array([[140.0, 0, 80], [0, 140.0, 60], [0, 0, 1]], np.float32)


def write_ply(path, verts, faces, colors=None) -> None:
    """An ASCII .ply of float vertices, optional uchar colours (from [0, 1])
    and triangles."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            line = f"{v[0]} {v[1]} {v[2]}"
            if colors is not None:
                c = (colors[i] * 255).astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def _poses(num_class: int, seed: int, img_id: int, rng):
    """Per object: the ground-truth (R, t) and its annotations, and the
    jittered reference pose (6 degrees, 5/5/15 mm)."""
    poses, anns, refs = [], [], []
    for oi in range(num_class):
        R = Rotation.random(random_state=seed * 100 + img_id * 10 + oi).as_matrix()
        if num_class <= 4:
            t = np.array([(oi - 0.5) * 60, 0, 500.0 + 30 * oi])
        else:
            # more than 4 classes: a 4-wide grid keeps every object in the
            # 120x160 frame (a line walks off its right edge)
            col, row = oi % 4, oi // 4
            nrow = (num_class + 3) // 4
            t = np.array([(col - 1.5) * 70, (row - (nrow - 1) / 2) * 55, 500.0 + 12 * oi])
        poses.append((R, t))
        anns.append(dict(cam_R_m2c=R.reshape(-1).tolist(), cam_t_m2c=t.tolist(), obj_id=oi + 1))
        dR = Rotation.from_euler("xyz", rng.normal(size=3) * 6, degrees=True).as_matrix()
        ref_t = t + rng.normal(size=3) * np.array([5, 5, 15])
        refs.append(dict(cam_R_m2c=(dR @ R).reshape(-1).tolist(), cam_t_m2c=ref_t.tolist(),
                         obj_id=oi + 1))
    return poses, anns, refs


def _rendered_frame(renderer, poses, num_class: int):
    """The objects rendered at their poses over grey (composited in object
    order; the poses do not overlap): (BGR uint8 frame, masks)."""
    Rb = np.stack([p[0] for p in poses]).astype(np.float32)
    tb = np.stack([p[1] for p in poses]).astype(np.float32)
    out = renderer(Rb, tb, np.tile(K[None], (num_class, 1, 1)), np.arange(num_class))
    imgs = out["images"].cpu().numpy()
    masks_r = out["masks"].cpu().numpy()
    img = np.full((*IMG_HW, 3), 0.35, np.float32)
    masks = []
    for oi in range(num_class):
        m = masks_r[oi] > 0
        img[m] = imgs[oi][m]
        masks.append((m * 255).astype(np.uint8))
    return (img[..., ::-1] * 255).astype(np.uint8), masks


def _noise_frame(poses, rng):
    """A noise frame and, per object, a filled disc of radius 18 at its
    projected centre."""
    img = rng.integers(0, 255, size=(*IMG_HW, 3), dtype=np.uint8)
    masks = []
    for R, t in poses:
        c2d = K @ t
        m = np.zeros(IMG_HW, np.uint8)
        fill_circle(m, (int(c2d[0] / c2d[2]), int(c2d[1] / c2d[2])), 18, 255)
        masks.append(m)
    return img, masks


def _box_info(m: np.ndarray) -> dict:
    ys, xs = np.nonzero(m)
    x1, y1 = (int(xs.min()), int(ys.min())) if len(xs) else (0, 0)
    x2, y2 = (int(xs.max()), int(ys.max())) if len(xs) else (1, 1)
    box = [x1, y1, x2 - x1, y2 - y1]
    return dict(bbox_obj=box, bbox_visib=list(box), visib_fract=1.0,
                px_count_visib=int((m > 0).sum()))


def build_synthetic_bop(root, num_images: int = 3, num_class: int = 2,
                        render_images: bool = False, seed: int = 0, device=None) -> dict:
    """Write the set under `root` (num_images frames of 120x160, each
    holding every one of num_class 60 mm synthetic cubes) and return
    {'root', 'diameters', 'num_class'}.  render_images renders the frames
    with render.renderer.Renderer on `device` (None: the card) through its
    default backend, 'xla' (the frames' 160-pixel rows are no multiple of
    the kernel's 128-pixel tiles)."""
    root = Path(root)
    seq = root / "train_real" / "000001"
    (seq / "rgb").mkdir(parents=True, exist_ok=True)
    (seq / "mask_visib").mkdir(parents=True, exist_ok=True)
    for sub in ("models_eval", "models_1024", "image_lists"):
        (root / sub).mkdir(exist_ok=True)

    bank = make_synthetic_bank(num_class, size=60.0)
    diameters = []
    for c in range(num_class):
        v = bank.verts[c][bank.vert_valid[c]]
        f = bank.faces[c][bank.face_valid[c]]
        col = bank.colors[c][bank.vert_valid[c]]
        for sub in ("models_eval", "models_1024"):
            write_ply(root / sub / f"obj_{c + 1:06d}.ply", v, f, col)
        diameters.append(float(np.linalg.norm(v[:, None] - v[None], axis=-1).max()))

    renderer = None
    if render_images:
        from scflow_tpu_torch.render.renderer import Renderer

        renderer = Renderer(bank=bank, image_size=IMG_HW, chunk=16, device=device)

    rng = np.random.default_rng(seed)
    scene_gt, scene_info, scene_cam, ref_gt, img_list = {}, {}, {}, {}, []
    for img_id in range(num_images):
        poses, anns, refs = _poses(num_class, seed, img_id, rng)
        if renderer is not None:
            img_u8, masks = _rendered_frame(renderer, poses, num_class)
        else:
            img_u8, masks = _noise_frame(poses, rng)
        imwrite(str(seq / "rgb" / f"{img_id:06d}.png"), img_u8)
        for oi, m in enumerate(masks):
            imwrite(str(seq / "mask_visib" / f"{img_id:06d}_{oi:06d}.png"), m)
        scene_gt[str(img_id)] = anns
        scene_info[str(img_id)] = [_box_info(m) for m in masks]
        scene_cam[str(img_id)] = dict(cam_K=K.reshape(-1).tolist(), depth_scale=1.0)
        ref_gt[str(img_id)] = refs
        img_list.append(f"000001/rgb/{img_id:06d}.png")

    (seq / "scene_gt.json").write_text(json.dumps(scene_gt))
    (seq / "scene_gt_info.json").write_text(json.dumps(scene_info))
    (seq / "scene_camera.json").write_text(json.dumps(scene_cam))
    (root / "image_lists" / "train.txt").write_text("\n".join(img_list))
    ref_dir = root / "initial_poses" / "000001"
    ref_dir.mkdir(parents=True, exist_ok=True)
    (ref_dir / "scene_gt.json").write_text(json.dumps(ref_gt))

    kps = []
    for c in range(num_class):
        v = bank.verts[c][bank.vert_valid[c]]
        mn, mx = v.min(0), v.max(0)
        kps.append([[float(x), float(y), float(z)]
                    for x in (mn[0], mx[0]) for y in (mn[1], mx[1]) for z in (mn[2], mx[2])])
    (root / "keypoints.json").write_text(json.dumps(kps))
    return dict(root=root, diameters=diameters, num_class=num_class)
