"""Host-side numpy copy of lc_tpu/data/bop.py (importing lc_tpu would pull in jax).

BOP annotation loading from image lists, with npy caching.

Semantics match reference lib/bop.py:24-241: per frame in a list file
(`split/scene/rgb/im.png` lines), read the scene's scene_gt / scene_gt_info /
scene_camera JSONs once, filter instances by visib_fract / obj_id / px_count, and
emit flattened (im_info, inst_info) records with numpy matrices and a 7-vector
quaternion pose state. Cache keyed by list names + filters.
"""
from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
from scipy.spatial.transform import Rotation as sciR


def gen_base_cache_path(file_list_names, visib_fract_th=None,
                        px_count_visib_th=None, scene_ids=None, obj_ids=None,
                        cache_dir='.cache'):
    if not isinstance(file_list_names, (list, tuple)):
        file_list_names = [file_list_names]
    names = ','.join(sorted(osp.splitext(osp.split(f)[1])[0]
                            for f in file_list_names))
    s = 'all' if scene_ids is None else ','.join(map(str, scene_ids))
    o = 'all' if obj_ids is None else ','.join(map(str, obj_ids))
    vf = '0' if visib_fract_th is None else str(visib_fract_th)
    vp = '0' if px_count_visib_th is None else str(px_count_visib_th)
    name = f'{names}_vf{vf}_vp{vp}_s{s}_o{o}'.replace(' ', '')
    return name if cache_dir is None else osp.join(cache_dir, name)


def _to_np(v):
    if not isinstance(v, (list, tuple)):
        return v
    arr = np.asarray(v)
    if len(v) == 9:
        return arr.reshape(3, 3).astype(np.float32)
    if len(v) == 3:
        return arr.reshape(3, 1).astype(np.float32)
    return arr


def load_annots_from_image_list(file_list_names, dataset_root, *, flatten=True,
                                visib_fract_th=None, px_count_visib_th=None,
                                scene_ids=None, obj_ids=None, cache_dir='.cache',
                                gt_keys=('px_count_visib',), im_wh=(640, 480)):
    """Returns a list of (im_info dict, inst_info dict) records (flattened) or
    (im_info, [inst_info, ...]) when flatten=False."""
    if isinstance(file_list_names, str):
        file_list_names = [file_list_names]

    cache_path = None
    if cache_dir:
        cache_path = gen_base_cache_path(
            file_list_names, visib_fract_th, px_count_visib_th, scene_ids,
            obj_ids, cache_dir) + '.npy'
        if osp.exists(cache_path):
            annots = np.load(cache_path, allow_pickle=True).item()['all_annots']
            return _flatten(annots) if flatten else annots

    keep_keys = {'cam_R_m2c', 'cam_t_m2c', 'obj_id', 'inst_idx'}.union(
        gt_keys or ())
    scene_ids = set(scene_ids) if scene_ids is not None else None
    obj_id_set = set(obj_ids) if obj_ids is not None else None

    frames = []
    for fname in file_list_names:
        with open(fname) as f:
            frames.extend(line.rstrip() for line in f if line.strip())
    frames = sorted(frames)

    scene_cache: dict = {}
    records = []
    for frame in frames:
        parts = frame.rsplit('/', 3)
        split, scene_id, im_id = parts[-4], int(parts[-3]), \
            int(parts[-1].split('.')[0])
        if scene_ids is not None and scene_id not in scene_ids:
            continue
        skey = (scene_id, split)
        if skey not in scene_cache:
            base = osp.join(dataset_root, split, f'{scene_id:06d}')
            with open(osp.join(base, 'scene_gt.json')) as f:
                gt = json.load(f)
            with open(osp.join(base, 'scene_gt_info.json')) as f:
                gt_info = json.load(f)
            with open(osp.join(base, 'scene_camera.json')) as f:
                cam = json.load(f)
            scene_cache[skey] = (gt, gt_info, cam)
        gt, gt_info, cam = scene_cache[skey]
        imk = str(im_id)

        insts = []
        for idx, (g, gi) in enumerate(zip(gt[imk], gt_info[imk])):
            inst = dict(g)
            inst.update(gi)
            inst['inst_idx'] = idx
            if visib_fract_th is not None and \
                    inst.get('visib_fract', 1.0) < visib_fract_th:
                continue
            if obj_id_set is not None and inst['obj_id'] not in obj_id_set:
                continue
            if px_count_visib_th is not None and \
                    inst.get('px_count_visib', 1 << 30) < px_count_visib_th:
                continue
            insts.append(inst)
        if not insts:
            continue

        im_info = {'rgb': frame, 'split': split, 'scene_id': scene_id,
                   'im_id': im_id, 'im_wh': tuple(im_wh)}
        im_info.update({k: _to_np(v) for k, v in cam[imk].items()})
        insts = [{k: _to_np(inst[k]) for k in keep_keys if k in inst}
                 for inst in insts]
        records.append((im_info, insts))

    _append_quaternion_state(records)

    if cache_path:
        # written aside and renamed: data-parallel ranks build the same
        # cache at once, and none may read another's half-written file
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f'{cache_path[:-4]}.{os.getpid()}.tmp.npy'
        np.save(tmp, {'all_annots': records})
        os.replace(tmp, cache_path)
    return _flatten(records) if flatten else records


def _flatten(annots):
    if annots and not isinstance(annots[0][1], list):
        return annots
    return [(im, inst) for im, insts in annots for inst in insts]


def _append_quaternion_state(records):
    insts = [i for _, lst in records for i in lst]
    if not insts:
        return
    Rs = np.stack([i['cam_R_m2c'] for i in insts])
    ts = np.stack([i['cam_t_m2c'] for i in insts])[..., 0]
    q_xyzw = sciR.from_matrix(Rs.astype(np.float64)).as_quat()
    q = np.roll(q_xyzw, 1, axis=-1)  # wijk
    q = np.where(q[:, :1] < 0, -q, q)
    states = np.concatenate((q, ts), axis=-1).astype(np.float32)
    for i, inst in enumerate(insts):
        inst['state'] = states[i]


def mask_path(im_info: dict, inst_info: dict, key: str = 'mask_visib') -> str:
    return osp.join(im_info['split'], f"{im_info['scene_id']:06d}", key,
                    f"{im_info['im_id']:06d}_{inst_info['inst_idx']:06d}.png")


def z_crop_path(im_info: dict, inst_info: dict) -> str:
    return osp.join(im_info['split'], 'z_crop', f"{im_info['scene_id']:06d}",
                    f"{im_info['im_id']:06d}_{inst_info['inst_idx']:06d}.pkl.gz")
