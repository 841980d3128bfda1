"""Offline z_crop depth-patch generation (the port's copy of lc_tpu's
tools/gen_z.py, the reference tools/gen_z.py equivalent; no jax).

Reference-parity invocation (tools/gen_z.py:192-226 — data_dir IS the split
directory, scene range via --begin/--end or --scene):

    python -m lc_tpu_torch.tools.gen_z --dataset lmo \
        --data_dir .../lmo/train_pbr \
        [--scene 3 | --begin 0 --end 10] [--xyz_root ...] [--model_dir ...] \
        [--remove_existing]

Convenience form (dataset root + split name):

    python -m lc_tpu_torch.tools.gen_z --data_dir .../lmo --split train \
        --scenes 1 2 ...

For every GT instance, renders the object's depth at the camera pose with the
software rasterizer (no OpenGL needed), crops to the mask bbox, normalizes depth to
uint16 1..65535 over [z_min, z_max], and writes gzip pickles
{z_crop, xyxy, z_max, z_min} under <xyz_root>/<scene>/<im>_<inst>.pkl.gz —
the exact format dataset loading consumes (reference tools/gen_z.py:169-187,
consumed at dataset.py:287-311 / our data/pipeline.py _homo_z_full).
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import os.path as osp
import pickle
import sys

import numpy as np

from ..data.mesh import load_ply_mesh, rasterize_depth


def mask2bbox_xyxy(mask: np.ndarray):
    ys, xs = np.nonzero(mask)
    return int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())


def process_scene(split_dir: str, scene_id: int, meshes: dict,
                  xyz_root: str | None = None, im_hw=(480, 640),
                  remove_existing: bool = False):
    scene_dir = osp.join(split_dir, f'{scene_id:06d}')
    with open(osp.join(scene_dir, 'scene_gt.json')) as f:
        scene_gt = json.load(f)
    with open(osp.join(scene_dir, 'scene_camera.json')) as f:
        scene_cam = json.load(f)
    xyz_root = xyz_root or osp.join(split_dir, 'z_crop')
    out_dir = osp.join(xyz_root, f'{scene_id:06d}')
    os.makedirs(out_dir, exist_ok=True)

    for im_key, insts in scene_gt.items():
        im_id = int(im_key)
        K = np.asarray(scene_cam[im_key]['cam_K'], np.float64).reshape(3, 3)
        for inst_idx, inst in enumerate(insts):
            obj_id = inst['obj_id']
            if obj_id not in meshes:
                # out-of-dataset object: leave any existing pickle alone —
                # deleting before this check would permanently drop z_crops
                # of objects filtered out by --dataset
                continue
            out_path = osp.join(out_dir, f'{im_id:06d}_{inst_idx:06d}.pkl.gz')
            if osp.exists(out_path):
                if not remove_existing:
                    continue
                os.remove(out_path)
            verts, faces = meshes[obj_id]
            R = np.asarray(inst['cam_R_m2c'], np.float64).reshape(3, 3)
            t = np.asarray(inst['cam_t_m2c'], np.float64).reshape(3)
            depth = rasterize_depth(verts, faces, K, R, t, im_hw)
            mask = depth > 0
            if not mask.any():
                blob = {'z_crop': np.zeros((1, 1), np.uint16),
                        'xyxy': (0, 0, 0, 0), 'z_max': 0.0, 'z_min': 0.0}
            else:
                x1, y1, x2, y2 = mask2bbox_xyxy(mask)
                crop = depth[y1:y2 + 1, x1:x2 + 1]
                cm = mask[y1:y2 + 1, x1:x2 + 1]
                zv = crop[cm]
                z_min, z_max = float(zv.min()), float(zv.max())
                denom = max(z_max - z_min, 1e-6)
                z16 = np.zeros_like(crop, np.uint16)
                z16[cm] = (np.clip((crop[cm] - z_min) / denom, 0, 1)
                           * 65534 + 1).astype(np.uint16)
                blob = {'z_crop': z16, 'xyxy': (x1, y1, x2, y2),
                        'z_max': z_max, 'z_min': z_min}
            with gzip.open(out_path, 'wb') as f:
                pickle.dump(blob, f)
        print(f'scene {scene_id} im {im_id}: done', flush=True)


# reference gen_z.py class tables: which obj ids each dataset renders
DATASET_OBJ_IDS = {
    'lmo': [1, 5, 6, 8, 9, 10, 11, 12],
    'ycbv': list(range(1, 22)),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description='gen z_crop')
    ap.add_argument('--data_dir', required=True,
                    help='split dir (reference form) or dataset root '
                         '(with --split)')
    ap.add_argument('--dataset', choices=['ycbv', 'lmo'],
                    help='restrict rendered obj ids to the dataset class table '
                         '(reference --dataset)')
    ap.add_argument('--split', default=None,
                    help='split name under data_dir; omit when data_dir IS the '
                         'split dir (reference form)')
    ap.add_argument('--scene', type=int, help='single scene (reference form)')
    ap.add_argument('--begin', type=int, default=0)
    ap.add_argument('--end', type=int, default=sys.maxsize)
    ap.add_argument('--scenes', type=int, nargs='*')
    ap.add_argument('--remove_existing', action='store_true')
    ap.add_argument('--xyz_root', default=None,
                    help='output root (default <split_dir>/z_crop)')
    ap.add_argument('--model_dir', default=None,
                    help='default <split_dir>/../models')
    args = ap.parse_args(argv)

    split_dir = osp.join(args.data_dir, args.split) if args.split \
        else args.data_dir
    if args.model_dir:
        model_dir = args.model_dir
        if not osp.isabs(model_dir):
            # historical form: a name relative to data_dir (e.g. 'models');
            # fall back to CWD-relative (reference verbatim form) otherwise
            cand = osp.join(args.data_dir, model_dir)
            if osp.isdir(cand):
                model_dir = cand
    else:
        model_dir = osp.join(split_dir, '..', 'models')
    with open(osp.join(model_dir, 'models_info.json')) as f:
        obj_ids = [int(k) for k in json.load(f)]
    if args.dataset:
        keep = set(DATASET_OBJ_IDS[args.dataset])
        obj_ids = [o for o in obj_ids if o in keep]
    meshes = {oid: load_ply_mesh(osp.join(model_dir, f'obj_{oid:06d}.ply'))
              for oid in obj_ids}

    if args.scene is not None:
        args.begin, args.end = args.scene, args.scene + 1
    all_scenes = sorted(int(d) for d in os.listdir(split_dir) if d.isdigit())
    scenes = args.scenes or [s for s in all_scenes
                             if args.begin <= s < args.end]
    for sid in scenes:
        process_scene(split_dir, sid, meshes, xyz_root=args.xyz_root,
                      remove_existing=args.remove_existing)


if __name__ == '__main__':
    main()
