"""BOP dataset + input pipeline, eval branch (counterpart of
lc_tpu/data/pipeline.py).

Host (thread pool): image decode, the DZI crop box and affine matrices.
Device: the full-image bilinear RGB crop and normalization
(`device_preprocess`). The training branch (augmentation, rotated crops,
targets) arrives with the training slice.
"""
from __future__ import annotations

import collections
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import bop
from .crop import batched_separable_warp
from .model_info import load_composed_model_info
from ..geom.affine import affine33, crop_affine

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _load_detections(det_path: str) -> dict:
    """Best-scoring detector bbox per (scene/im, obj)."""
    import json
    with open(det_path) as f:
        raw = json.load(f)
    det = {}
    for k, v in raw.items():
        per_obj = {}
        for d in v:
            per_obj.setdefault(d['obj_id'], []).append(d)
        for oid, lst in per_obj.items():
            best = sorted(lst, key=lambda d: d['score'])[-1]
            det[f'{k}_{oid}'] = (np.asarray(best['bbox_est'], np.float32),
                                 float(best.get('score', 1.0)))
    return det


def eval_blob(rgb: np.ndarray, cam_K: np.ndarray, bbox_xywh, m_info: dict, *,
              obj_id: int, im_id: int, scene_id: int, net_input_wh,
              net_output_wh, dzi_pad_scale: float, det_score: float = 1.0
              ) -> dict:
    """The host blob of one eval crop: full RGB frame, the unrotated DZI crop
    affines around the box center and the crop's camera matrix."""
    H, W = rgb.shape[:2]
    bbox_xywh = np.asarray(bbox_xywh, np.float32)
    bbox_xyxy = np.concatenate((bbox_xywh[:2], bbox_xywh[:2] + bbox_xywh[2:]))
    center = (bbox_xyxy[:2] + bbox_xyxy[2:]) * 0.5
    scale = float(max(bbox_xywh[2], bbox_xywh[3], 1)) * dzi_pad_scale
    out_aff = crop_affine(center, scale, 0.0, net_output_wh).astype(np.float32)
    in_aff = crop_affine(center, scale, 0.0, net_input_wh).astype(np.float32)
    return {
        'rgb_full': rgb,
        'msk_full': np.zeros((H, W), np.uint8),
        'in_affine': in_aff,
        'out_affine': out_aff,
        'out_K': (affine33(out_aff) @ cam_K).astype(np.float32),
        'noc_scale': m_info['noc_scale_xfd'].astype(np.float32),
        'noc_scale_ori': m_info['noc_scale_ori'].astype(np.float32),
        'out_pix_scale': np.float32(scale / net_output_wh[0]),
        'obj_id': np.int32(obj_id),
        'im_id': np.int32(im_id),
        'scene_id': np.int32(scene_id),
        'pixel_aug': np.bool_(False),
        'det_score': np.float32(det_score),
    }


class BOPDataset:
    """Host-side eval sample assembly from a BOP tree."""

    def __init__(self, cfg_dataset, cfg_global):
        if cfg_global.get('max_bit_cnt', 0) > 0:
            raise NotImplementedError(
                'binary (zebra) targets arrive with the zebra slice')
        if cfg_global.get('sparse_cnt', 0) > 0:
            raise NotImplementedError(
                'sparse keypoints arrive with the sparse slice')
        import cv2
        self._cv2 = cv2
        cv2.setNumThreads(0)
        self.cfg = cfg_dataset

        annots = []
        for list_file in cfg_dataset.list_files:
            annots.extend(bop.load_annots_from_image_list(
                list_file, cfg_dataset.dataset_root, flatten=True,
                visib_fract_th=max(cfg_dataset.get('visib_frac', 0), 0),
                obj_ids=cfg_global.get('obj_ids'),
                cache_dir=cfg_global.get('cache_dir', ''),
                gt_keys=['bbox_visib']))
        if cfg_dataset.get('detection'):
            det = _load_detections(cfg_dataset.detection)
            kept = []
            for im, inst in annots:
                key = f"{im['scene_id']}/{im['im_id']}_{inst['obj_id']}"
                if key in det:
                    inst = dict(inst)
                    inst['bbox_det'], inst['det_score'] = det[key]
                    kept.append((im, inst))
            annots = kept
        if not annots:
            raise RuntimeError('no annotations after filtering')
        self.annots = annots
        self.model_info = load_composed_model_info(
            cfg_dataset.dataset_root,
            transform_model=cfg_global.get('transform_model', False),
            xform_path=cfg_global.get('transform_path'))
        self.bit_cnt = None
        self.net_input_wh = tuple(cfg_global.get(
            'net_input_wh', cfg_dataset.get('net_input_wh', (256, 256))))
        self.net_output_wh = tuple(cfg_global.get(
            'net_output_wh', cfg_dataset.get('net_output_wh', (64, 64))))

    def __len__(self):
        return len(self.annots)

    def sample(self, index: int) -> dict:
        """One eval host blob."""
        cv2 = self._cv2
        im_info, inst_info = self.annots[index]
        bgr = cv2.imread(osp.join(self.cfg.dataset_root, im_info['rgb']),
                         cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(im_info['rgb'])
        bbox = inst_info.get('bbox_det')
        if bbox is None:
            bbox = inst_info['bbox_visib']
        obj_id = inst_info['obj_id']
        return eval_blob(
            np.ascontiguousarray(bgr[..., ::-1]), im_info['cam_K'], bbox,
            self.model_info[obj_id], obj_id=obj_id, im_id=im_info['im_id'],
            scene_id=im_info['scene_id'], net_input_wh=self.net_input_wh,
            net_output_wh=self.net_output_wh,
            dzi_pad_scale=self.cfg.dzi_pad_scale,
            det_score=inst_info.get('det_score', 1.0))


def collate(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class Loader:
    """In-order batches of dataset.sample() blobs, assembled by a pool of
    threads with up to max(prefetch, num_threads) batches in flight."""

    def __init__(self, dataset, batch_size: int, *, num_threads: int = 4,
                 prefetch: int = 2):
        self.ds = dataset
        self.batch_size = batch_size
        self.num_threads = max(num_threads, 1)
        self.window = max(prefetch, self.num_threads)

    def __len__(self):
        return -(-len(self.ds) // self.batch_size)

    def _batch(self, i: int) -> dict:
        stop = min((i + 1) * self.batch_size, len(self.ds))
        return collate([self.ds.sample(j)
                        for j in range(i * self.batch_size, stop)])

    def __iter__(self):
        pending: collections.deque = collections.deque()
        with ThreadPoolExecutor(self.num_threads) as pool:
            try:
                for i in range(len(self)):
                    pending.append(pool.submit(self._batch, i))
                    if len(pending) >= self.window:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()


def device_preprocess(batch: dict, *, net_input_wh) -> dict:
    """Device stage of the eval pipeline: crop the RGB frames to the network
    input (bf16 matmuls, as for 8-bit RGB in lc_tpu), normalize, and pass the
    other fields through. batch: dict of tensors on the target device."""
    in_hw = (net_input_wh[1], net_input_wh[0])
    rgb_full = batch['rgb_full'].to(torch.float32)
    rgb_in = batched_separable_warp(rgb_full, batch['in_affine'], in_hw,
                                    'bilinear', compute_dtype=torch.bfloat16)
    dev = rgb_in.device
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    out = {k: v for k, v in batch.items()
           if k not in ('rgb_full', 'msk_full', 'in_affine', 'pixel_aug')}
    out['img_in'] = (rgb_in / 255.0 - mean) / std
    return out
