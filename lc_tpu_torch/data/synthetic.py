"""Synthetic BOP-format data (numpy copy of lc_tpu/data/synthetic.py, plus an
in-memory eval set).

The real BOP datasets are not shipped with either repo; integration tests and the
benchmark need an end-to-end-compatible stand-in. This module ray-casts a textured
box analytically (exact depth + mask, no GL) and writes a miniature dataset in the
exact on-disk BOP layout the loaders consume: rgb/, mask_visib/, scene_gt.json,
scene_gt_info.json, scene_camera.json, models/models_info.json, models_eval/*.ply,
z_crop/*.pkl.gz (gen_z format, reference tools/gen_z.py:169-187) and an image list.
"""
from __future__ import annotations

import gzip
import json
import os
import os.path as osp
import pickle

import numpy as np
from scipy.spatial.transform import Rotation as sciR

K_DEFAULT = np.array([[572.4114, 0, 325.2611],
                      [0, 573.57043, 242.04899],
                      [0, 0, 1]], np.float32)


def _cast(K, R, t, half_extents, us, vs):
    """Rays through pixel coordinates (us, vs) against the box: model-frame
    hit points (M, 3), hit mask, ray parameter s and camera-frame directions."""
    pix = np.stack((us, vs, np.ones_like(us)), axis=-1).reshape(-1, 3)
    d_cam = pix @ np.linalg.inv(K).T                      # (N, 3)
    o_m = (-R.T @ t).reshape(3)
    d_m = d_cam @ R                                        # rows Rᵀ d

    inv_d = 1.0 / np.where(np.abs(d_m) < 1e-12, 1e-12, d_m)
    t1 = (-half_extents - o_m) * inv_d
    t2 = (half_extents - o_m) * inv_d
    t_near = np.minimum(t1, t2).max(axis=-1)
    t_far = np.maximum(t1, t2).min(axis=-1)
    hit = (t_far > np.maximum(t_near, 0.0))
    s = np.where(hit, t_near, 0.0)
    return o_m + s[:, None] * d_m, hit, s, d_cam


def raycast_box(K: np.ndarray, R: np.ndarray, t: np.ndarray,
                half_extents: np.ndarray, im_hw=(480, 640)):
    """Exact ray-box render: returns (depth (H,W) float mm, mask (H,W) bool,
    rgb (H,W,3) uint8 with per-face shading + NOC tint)."""
    H, W = im_hw
    us, vs = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    x_m, hit, s, d_cam = _cast(K, R, t, half_extents, us, vs)
    depth = s * d_cam[:, 2]                                # z in camera frame

    # shading: which slab face was hit (argmax |x_m| / extent), signed
    face = np.argmax(np.abs(x_m) / half_extents, axis=-1)
    sign = np.take_along_axis(np.sign(x_m), face[:, None], axis=-1)[:, 0]
    base = np.asarray([90, 140, 190], np.float32)[face] + 30.0 * (sign > 0)
    noc = (x_m / half_extents + 1.0) * 0.5                  # [0,1]³ texture tint
    rgb = np.clip(base[:, None] * (0.55 + 0.45 * noc), 0, 255).astype(np.uint8)
    rgb = np.where(hit[:, None], rgb, 0)

    return (depth.reshape(H, W).astype(np.float32),
            hit.reshape(H, W),
            rgb.reshape(H, W, 3))


def _write_ply_ascii(path: str, verts: np.ndarray):
    with open(path, 'w') as f:
        f.write('ply\nformat ascii 1.0\n'
                f'element vertex {len(verts)}\n'
                'property float x\nproperty float y\nproperty float z\n'
                'end_header\n')
        for v in verts:
            f.write(f'{v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n')


def box_mesh(half_extents: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Triangulated box: (8, 3) corners, (12, 3) faces."""
    he = np.asarray(half_extents, np.float32)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float32) * he
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    return corners, np.asarray(faces, np.int64)


def _write_ply_mesh_ascii(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, 'w') as f:
        f.write('ply\nformat ascii 1.0\n'
                f'element vertex {len(verts)}\n'
                'property float x\nproperty float y\nproperty float z\n'
                f'element face {len(faces)}\n'
                'property list uchar int vertex_indices\n'
                'end_header\n')
        for v in verts:
            f.write(f'{v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n')
        for fc in faces:
            f.write(f'3 {fc[0]} {fc[1]} {fc[2]}\n')


def box_surface_points(half_extents: np.ndarray, n_per_face: int = 64
                       ) -> np.ndarray:
    """Evenly sampled points on the box surface (models_eval stand-in)."""
    g = int(np.sqrt(n_per_face))
    lin = np.linspace(-1, 1, g)
    uu, vv = np.meshgrid(lin, lin)
    uu, vv = uu.reshape(-1), vv.reshape(-1)
    pts = []
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            p = np.zeros((len(uu), 3))
            p[:, axis] = sgn
            p[:, (axis + 1) % 3] = uu
            p[:, (axis + 2) % 3] = vv
            pts.append(p)
    return (np.concatenate(pts) * half_extents).astype(np.float32)


def generate_dataset(root: str, *, n_images: int = 24, obj_id: int = 1,
                     half_extents=(40.0, 30.0, 20.0), split: str = 'train_syn',
                     seed: int = 0, im_hw=(480, 640), symmetric: bool = False,
                     list_name: str | None = None) -> str:
    """Create the dataset under `root`; returns the image-list file path.
    PNGs are written with cv2 (lc_tpu's copy uses imageio, which the machine
    with the card lacks); the files are the same lossless images."""
    import cv2
    rng = np.random.default_rng(seed)
    he = np.asarray(half_extents, np.float32)
    H, W = im_hw
    scene_id = 1
    scene_dir = osp.join(root, split, f'{scene_id:06d}')
    os.makedirs(osp.join(scene_dir, 'rgb'), exist_ok=True)
    os.makedirs(osp.join(scene_dir, 'mask_visib'), exist_ok=True)
    os.makedirs(osp.join(root, split, 'z_crop', f'{scene_id:06d}'), exist_ok=True)
    os.makedirs(osp.join(root, 'models'), exist_ok=True)
    os.makedirs(osp.join(root, 'models_eval'), exist_ok=True)

    diameter = float(2.0 * np.linalg.norm(he))
    info = {'min_x': -float(he[0]), 'min_y': -float(he[1]), 'min_z': -float(he[2]),
            'size_x': 2 * float(he[0]), 'size_y': 2 * float(he[1]),
            'size_z': 2 * float(he[2]), 'diameter': diameter}
    if symmetric:
        m = np.eye(4)
        m[:3, :3] = sciR.from_rotvec([0, 0, np.pi]).as_matrix()
        info['symmetries_discrete'] = [m.reshape(-1).tolist()]
    with open(osp.join(root, 'models', 'models_info.json'), 'w') as f:
        json.dump({str(obj_id): info}, f)
    verts = box_surface_points(he)
    _write_ply_ascii(osp.join(root, 'models_eval', f'obj_{obj_id:06d}.ply'), verts)
    with open(osp.join(root, 'models_eval', 'models_info.json'), 'w') as f:
        json.dump({str(obj_id): info}, f)
    # triangulated mesh under models/ so tools/gen_z.py can re-render z_crop
    mv, mf = box_mesh(he)
    _write_ply_mesh_ascii(osp.join(root, 'models', f'obj_{obj_id:06d}.ply'),
                          mv, mf)

    scene_gt, scene_gt_info, scene_cam = {}, {}, {}
    frames = []
    for im_id in range(n_images):
        R = sciR.random(random_state=int(rng.integers(1 << 30))).as_matrix()
        t = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                      rng.uniform(550, 850)])
        depth, mask, rgb = raycast_box(K_DEFAULT, R, t, he, im_hw)
        # light background texture so background switching/eval have signal
        bg = (rng.integers(20, 90, (H // 8, W // 8, 3))
              .repeat(8, 0).repeat(8, 1)).astype(np.uint8)
        rgb = np.where(mask[..., None], rgb, bg)

        ys, xs = np.nonzero(mask)
        x1, y1, x2, y2 = xs.min(), ys.min(), xs.max(), ys.max()
        bbox = [int(x1), int(y1), int(x2 - x1 + 1), int(y2 - y1 + 1)]

        cv2.imwrite(osp.join(scene_dir, 'rgb', f'{im_id:06d}.png'),
                    np.ascontiguousarray(rgb[..., ::-1]))
        cv2.imwrite(osp.join(scene_dir, 'mask_visib',
                             f'{im_id:06d}_{0:06d}.png'),
                    (mask * 255).astype(np.uint8))

        # z_crop in gen_z.py format: uint16 in 1..65535 over [z_min, z_max]
        crop = depth[y1:y2 + 1, x1:x2 + 1].copy()
        cmask = mask[y1:y2 + 1, x1:x2 + 1]
        z_valid = crop[cmask]
        z_min, z_max = float(z_valid.min()), float(z_valid.max())
        denom = max(z_max - z_min, 1e-6)
        z16 = np.zeros_like(crop, np.uint16)
        z16[cmask] = (np.clip((crop[cmask] - z_min) / denom, 0, 1)
                      * 65534 + 1).astype(np.uint16)
        blob = {'z_crop': z16, 'xyxy': (int(x1), int(y1), int(x2), int(y2)),
                'z_max': z_max, 'z_min': z_min}
        with gzip.open(osp.join(root, split, 'z_crop', f'{scene_id:06d}',
                                f'{im_id:06d}_{0:06d}.pkl.gz'), 'wb') as f:
            pickle.dump(blob, f)

        imk = str(im_id)
        scene_gt[imk] = [{'cam_R_m2c': R.reshape(-1).tolist(),
                          'cam_t_m2c': t.tolist(), 'obj_id': obj_id}]
        scene_gt_info[imk] = [{'bbox_obj': bbox, 'bbox_visib': bbox,
                               'px_count_visib': int(mask.sum()),
                               'visib_fract': 1.0}]
        scene_cam[imk] = {'cam_K': K_DEFAULT.reshape(-1).tolist(),
                          'depth_scale': 1.0}
        frames.append(f'{split}/{scene_id:06d}/rgb/{im_id:06d}.png')

    for name, d in (('scene_gt', scene_gt), ('scene_gt_info', scene_gt_info),
                    ('scene_camera', scene_cam)):
        with open(osp.join(scene_dir, f'{name}.json'), 'w') as f:
            json.dump(d, f)

    list_path = osp.join(root, list_name or f'{split}_list.txt')
    with open(list_path, 'w') as f:
        f.write('\n'.join(frames) + '\n')
    return list_path


def oracle_grid(K: np.ndarray, R: np.ndarray, t: np.ndarray,
                half_extents: np.ndarray, hw) -> tuple[np.ndarray, np.ndarray]:
    """The exact NOC map (h, w, 3) a perfect network would predict on the grid
    uv[y, x] = (x, y) of camera K, and the object mask (h, w) on that grid:
    the box surface point where the pixel's ray hits it, else the ray's point
    at the depth of the object center. Every entry projects exactly onto its
    pixel under (R, t)."""
    h, w = hw
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    x_m, hit, _, d_cam = _cast(K.astype(np.float64), R, t, half_extents, us, vs)
    s_bg = t[2] / d_cam[:, 2]
    x_bg = (-R.T @ t).reshape(3) + s_bg[:, None] * (d_cam @ R)
    x_m = np.where(hit[:, None], x_m, x_bg)
    return ((x_m / half_extents).reshape(h, w, 3).astype(np.float32),
            hit.reshape(h, w))


def render_eval_set(n_images: int, *, seed: int = 0, obj_id: int = 1,
                    half_extents=(40.0, 30.0, 20.0), im_hw=(480, 640),
                    net_input_wh=(256, 256), net_output_wh=(64, 64),
                    dzi_pad_scale: float = 1.5, symmetric: bool = False,
                    sparse_cnt: int = 0) -> dict:
    """An eval set held in memory: one box per rendered frame, with the eval
    host blobs (the keys of data/pipeline.py::eval_blob), the GT records,
    model points and models_info an Evaluator needs, and the poses.
    symmetric: the object carries generate_dataset's discrete symmetry (180°
    about z) and is scored by ADD-S (`symmetric_obj_ids`); sparse_cnt > 0:
    the blobs carry the first sparse_cnt keypoints of
    box_surface_points(half_extents, 16) as pts3d, the keypoint pickle the
    sparse configs' recipe writes.

    Returns dict(blobs, gts, models, models_info, poses, half_extents,
    symmetric_obj_ids, keypoints)."""
    from .pipeline import eval_blob
    rng = np.random.default_rng(seed)
    he = np.asarray(half_extents, np.float32)
    H, W = im_hw
    info = {'min_x': -float(he[0]), 'min_y': -float(he[1]),
            'min_z': -float(he[2]), 'diameter': float(2.0 * np.linalg.norm(he))}
    if symmetric:
        m = np.eye(4)
        m[:3, :3] = sciR.from_rotvec([0, 0, np.pi]).as_matrix()
        info['symmetries_discrete'] = [m.reshape(-1).tolist()]
    m_info = {'noc_scale_xfd': np.abs(he), 'noc_scale_ori': np.abs(he)}
    keypoints = box_surface_points(he, 16)[:sparse_cnt] if sparse_cnt else None
    blobs, gts, poses = [], [], []
    for im_id in range(n_images):
        R = sciR.random(random_state=int(rng.integers(1 << 30))).as_matrix()
        t = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                      rng.uniform(550, 850)])
        _, mask, rgb = raycast_box(K_DEFAULT, R, t, he, im_hw)
        bg = (rng.integers(20, 90, (H // 8, W // 8, 3))
              .repeat(8, 0).repeat(8, 1)).astype(np.uint8)
        rgb = np.where(mask[..., None], rgb, bg)
        ys, xs = np.nonzero(mask)
        bbox = [xs.min(), ys.min(), xs.max() - xs.min() + 1,
                ys.max() - ys.min() + 1]
        blob = eval_blob(
            rgb, K_DEFAULT, bbox, m_info, obj_id=obj_id, im_id=im_id,
            scene_id=1, net_input_wh=net_input_wh, net_output_wh=net_output_wh,
            dzi_pad_scale=dzi_pad_scale)
        if keypoints is not None:
            blob['pts3d'] = keypoints.copy()
        blobs.append(blob)
        gts.append(dict(scene_id=1, im_id=im_id, obj_id=obj_id,
                        R_gt=R.astype(np.float32),
                        t_gt=t.astype(np.float32)[:, None],
                        cam_K=K_DEFAULT.copy(), im_w=float(W)))
        poses.append((R, t))
    return dict(blobs=blobs, gts=gts, poses=poses, half_extents=he,
                models={obj_id: box_surface_points(he)},
                models_info={obj_id: info},
                symmetric_obj_ids=[obj_id] if symmetric else [],
                keypoints=keypoints)


def oracle_outputs(es: dict, blobs: list[dict], net_output_wh, *,
                   bit_cnt=None, black_background: bool = False,
                   sparse: bool = False, logit: float = 4.0,
                   kpt_sigma: float = 1.0) -> dict:
    """Network outputs (numpy, channel-last) a perfect network would give on
    `blobs` of the eval set `es` (render_eval_set), on their output grid of
    net_output_wh:
      * dense heads: 'xyz_noc' (oracle NOC) or, with bit_cnt, 'xyz_noc_bin'
        (±logit on the Gray bits of the oracle NOC, codec.noc_to_bits);
        visibility ±8 and weight logits 0 / -30 on / off the object mask, a
        weight scale of h·w;
      * sparse head: 'kpt_logits', per keypoint of es['keypoints'] a
        Gaussian of std kpt_sigma px in logit space around its GT projection.
    """
    import torch
    from ..codec import noc_to_bits
    K_out = [b['out_K'].astype(np.float64) for b in blobs]
    poses = [es['poses'][int(b['im_id'])] for b in blobs]
    he = es['half_extents']
    w, h = net_output_wh
    hw = (h, w)
    if sparse:
        kp = es['keypoints'].astype(np.float64)
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
        out = []
        for Ko, (R, t) in zip(K_out, poses):
            uvz = (kp @ R.T + t) @ Ko.T
            uv = uvz[:, :2] / uvz[:, 2:]
            d2 = (xs[..., None] - uv[:, 0]) ** 2 \
                + (ys[..., None] - uv[:, 1]) ** 2
            out.append(-d2 / (2 * kpt_sigma ** 2))
        return {'kpt_logits': np.stack(out).astype(np.float32)}
    grids = [oracle_grid(Ko, R, t, he, hw) for Ko, (R, t) in zip(K_out, poses)]
    noc = np.stack([g[0] for g in grids])
    hit = np.stack([g[1] for g in grids])[..., None]
    B = len(blobs)
    out = {'xyz_weight_logits': np.where(hit, 0.0, -30.0).repeat(2, -1),
           'xyz_weights_scale': np.full((B, 1, 1, 1), float(h * w)),
           'msk_vis_logits': np.where(hit, 8.0, -8.0)}
    if bit_cnt is None:
        out['xyz_noc'] = noc
    else:
        bits, _ = noc_to_bits(torch.from_numpy(noc), bit_cnt, black_background)
        out['xyz_noc_bin'] = np.where(bits.numpy(), logit, -logit)
    return {k: v.astype(np.float32) for k, v in out.items()}


def render_train_set(n_images: int, *, seed: int = 0, obj_id: int = 1,
                     half_extents=(40.0, 30.0, 20.0), im_hw=(480, 640),
                     net_input_wh=(256, 256), net_output_wh=(64, 64),
                     dzi_scale_ratio: float = 0.25,
                     dzi_shift_ratio: float = 0.25, dzi_pad_scale: float = 1.5,
                     rotate_prob: float = 1.0, switch_bg_prob: float = 0.5,
                     pixel_aug_prob: float = 0.8, symmetric: bool = False,
                     sparse_cnt: int = 0) -> list[dict]:
    """Training host blobs held in memory, in the form BOPDataset.sample
    gives under dataloader.device_rotate with background switching: full
    frames and the crop's center, scale and rotation for the device's
    rotated crop, plus the output-resolution masks and homo_z map. Those
    are ray-cast directly at the crop's pixels (the source pixel of crop
    pixel x is the affine's inverse at x, plus half a pixel), where the
    dataset warps full-image maps with cv2; the background crops are random
    textures. symmetric: the object carries generate_dataset's discrete
    symmetry (180° about z), so Rt_candi holds its 2 GT-equivalent poses, as
    BOPDataset gives them for a sym_aware synthetic_sym tree; sparse_cnt >
    0: the blobs carry the first sparse_cnt keypoints of
    box_surface_points(half_extents, 16) as pts3d (render_eval_set's).
    Gray-code targets need nothing more: they are made on the device from
    homo_z_out. Needs numpy and scipy only."""
    import types
    from .model_info import bbox3d_from_scale
    from .pipeline import aug_bbox, check_points
    from ..geom.affine import affine33, crop_affine, invert_affine
    from ..geom.symmetry import pad_candidates, symmetry_pose_candidates
    rng = np.random.default_rng(seed)
    he = np.asarray(half_extents, np.float32)
    sym_info = {}
    if symmetric:
        m = np.eye(4)
        m[:3, :3] = sciR.from_rotvec([0, 0, np.pi]).as_matrix()
        sym_info['symmetries_discrete'] = [m.reshape(-1).tolist()]
    keypoints = box_surface_points(he, 16)[:sparse_cnt] if sparse_cnt else None
    H, W = im_hw
    out_w, out_h = net_output_wh
    in_w, in_h = net_input_wh
    dzi = types.SimpleNamespace(dzi_scale_ratio=dzi_scale_ratio,
                                dzi_shift_ratio=dzi_shift_ratio,
                                dzi_pad_scale=dzi_pad_scale)
    xs, ys = np.meshgrid(np.arange(out_w, dtype=np.float64),
                         np.arange(out_h, dtype=np.float64))
    blobs = []
    for im_id in range(n_images):
        R = sciR.random(random_state=int(rng.integers(1 << 30))).as_matrix()
        t = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                      rng.uniform(550, 850)])
        _, mask, rgb = raycast_box(K_DEFAULT, R, t, he, im_hw)
        bg = (rng.integers(20, 90, (H // 8, W // 8, 3))
              .repeat(8, 0).repeat(8, 1)).astype(np.uint8)
        rgb = np.where(mask[..., None], rgb, bg)
        yy, xx = np.nonzero(mask)
        bbox_xyxy = np.array([xx.min(), yy.min(), xx.max() + 1, yy.max() + 1],
                             np.float32)
        center, scale = aug_bbox(bbox_xyxy, H, W, rng, dzi)
        rotate = rng.random() * 4 * np.pi if rng.random() < rotate_prob else 0.0
        out_aff = crop_affine(center, scale, rotate, net_output_wh) \
            .astype(np.float32)
        inv = invert_affine(out_aff.astype(np.float64))
        su = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2] + 0.5
        sv = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2] + 0.5
        _, hit, s, d_cam = _cast(K_DEFAULT.astype(np.float64), R, t, he, su, sv)
        z = (s * d_cam[:, 2]).reshape(out_h, out_w)
        hit = hit.reshape(out_h, out_w)
        homo_z = np.where(hit[..., None],
                          np.stack((su * z, sv * z, z), -1), 0.0)
        sym_ck = check_points(hit, rng, 1)
        if sym_ck is None:
            raise RuntimeError(f'frame {im_id}: the crop misses the object')
        cands = symmetry_pose_candidates(R, t, sym_info)
        cands, cand_valid = pad_candidates(cands, len(cands))
        switch_bg = rng.random() < switch_bg_prob
        bg_crop = (rng.integers(0, 256, (in_h // 8, in_w // 8, 3))
                   .repeat(8, 0).repeat(8, 1).astype(np.uint8)) if switch_bg \
            else np.zeros((in_h, in_w, 3), np.uint8)
        blobs.append({
            'rgb_full': rgb,
            'crop_center': center.astype(np.float32),
            'crop_scale': np.float32(scale),
            'crop_rot': np.float32(rotate),
            'msk_vis_small': hit.astype(np.float32),
            'msk_full': (mask * 255).astype(np.uint8),
            'out_affine': out_aff,
            'out_K': (affine33(out_aff) @ K_DEFAULT).astype(np.float32),
            'noc_scale': he.copy(),
            'noc_scale_ori': he.copy(),
            'out_pix_scale': np.float32(scale / out_w),
            'obj_id': np.int32(obj_id),
            'im_id': np.int32(im_id),
            'scene_id': np.int32(1),
            'msk_noc_small': hit.astype(np.float32),
            'switch_bg': np.bool_(switch_bg),
            'bg_crop': bg_crop,
            'homo_z_out': homo_z.astype(np.float32),
            'K_no_aug': K_DEFAULT.copy(),
            'R_no_aug': R.astype(np.float32),
            't_no_aug': t.astype(np.float32),
            'sym_ck_pts2d': sym_ck,
            'Rt_candi': cands,
            'candi_valid': cand_valid,
            'bbox_3d': bbox3d_from_scale(he),
            'diameter': np.float32(2.0 * np.linalg.norm(he)),
            'pixel_aug': np.bool_(rng.random() < pixel_aug_prob),
        })
        if keypoints is not None:
            blobs[-1]['pts3d'] = keypoints.copy()
    return blobs
