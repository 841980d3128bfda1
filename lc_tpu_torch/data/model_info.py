"""Host-side numpy copy of lc_tpu/data/model_info.py (importing lc_tpu would pull in jax).

BOP models_info.json loading with optional canonical-frame transform.

Semantics match reference model_transform.py:6-42: per object, the NOC scale is
|[min_x, min_y, min_z]| (or the transformed scale from models_xform.json for YCB-V),
and bbox_3d_ori holds the 8 corners of the transformed NOC box mapped back into the
original model frame.
"""
from __future__ import annotations

import json
import os.path as osp

import numpy as np

_CORNER_SIGNS = np.array(
    [[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1],
     [-1, 1, 1], [-1, 1, -1], [-1, -1, 1], [-1, -1, -1]], np.float32)


def bbox3d_from_scale(noc_scale: np.ndarray) -> np.ndarray:
    return _CORNER_SIGNS * np.asarray(noc_scale, np.float32)


def load_composed_model_info(dataset_root: str, model_dir: str = 'models',
                             transform_model: bool = False,
                             xform_path: str | None = None) -> dict:
    with open(osp.join(dataset_root, model_dir, 'models_info.json')) as f:
        infos = {int(k): v for k, v in json.load(f).items()}
    xforms = {}
    if transform_model:
        xform_path = xform_path or osp.join(dataset_root, 'models_xform.json')
        with open(xform_path) as f:
            xforms = {int(k): v for k, v in json.load(f).items()}

    for k, v in infos.items():
        x_info = xforms.get(k)
        xform = np.eye(4, dtype=np.float32) if x_info is None else \
            np.asarray(x_info['xform'], np.float32).reshape(4, 4)
        ori_scale = np.abs(np.asarray(
            [v['min_x'], v['min_y'], v['min_z']], np.float32))
        xfd_scale = ori_scale if x_info is None else \
            np.asarray(x_info['xformed_noc_scale'], np.float32)
        v['xform'] = xform
        v['noc_scale_ori'] = ori_scale
        v['noc_scale_xfd'] = xfd_scale
        # corners of the xfd-frame NOC box expressed in the original model frame:
        # x_ori = Rᵀ (corner − t)
        v['bbox_3d_ori'] = (bbox3d_from_scale(xfd_scale) - xform[:3, 3]) \
            @ xform[:3, :3]
    return infos
