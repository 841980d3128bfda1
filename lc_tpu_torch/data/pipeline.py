"""BOP dataset + input pipeline (counterpart of lc_tpu/data/pipeline.py).

Host (a thread pool): image and mask decode, DZI jitter, the crop affines,
the small output-resolution warps (masks, homo_z), symmetry candidates and
background crops. Device (`device_preprocess`): the full-image crops of RGB
and mask, the rotated crop (ops/warp.py, the shear kernel) under
`dataloader.device_rotate`, background switching, colour augmentation and
normalization.

All batch shapes are static: symmetry candidates padded to the dataset's
largest K, check points fixed at 256, crops at the network's sizes.
"""
from __future__ import annotations

import collections
import gzip
import math
import os
import os.path as osp
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function

from . import bop
from .augment import color_augment, switch_background
from .crop import batched_separable_warp
from .model_info import load_composed_model_info
from ..codec import calc_bit_count
from ..geom.affine import affine33, crop_affine
from ..geom.symmetry import (DATASET_SYMMETRIC_OBJ_IDS, pad_candidates,
                             symmetry_pose_candidates)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

CHECK_PT_CNT = 256
# host-blob keys device_preprocess consumes and drops
_DEVICE_INPUT_KEYS = ('rgb_full', 'msk_full', 'bg_crop', 'in_affine',
                      'switch_bg', 'pixel_aug', 'rgb_in', 'msk_in',
                      'msk_vis_small', 'msk_noc_small', 'crop_center',
                      'crop_scale', 'crop_rot')


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


def aug_bbox(bbox_xyxy, H: int, W: int, rng: np.random.Generator,
             cfg_dataset) -> tuple[np.ndarray, float]:
    """DZI jitter of the box: (center, scale) with the scale capped at the
    image's larger side."""
    x1, y1, x2, y2 = bbox_xyxy
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    bw, bh = x2 - x1, y2 - y1
    scale_ratio = 1 + cfg_dataset.dzi_scale_ratio * (2 * rng.random() - 1)
    shift = cfg_dataset.dzi_shift_ratio * (2 * rng.random(2) - 1)
    center = np.array([cx + bw * shift[0], cy + bh * shift[1]])
    scale = max(y2 - y1, x2 - x1) * scale_ratio * cfg_dataset.dzi_pad_scale
    return center, float(min(scale, max(H, W)))


def check_points(msk_noc_small: np.ndarray, rng: np.random.Generator,
                 valid_pix_cnt_th: int):
    """CHECK_PT_CNT (x, y) pixels drawn from the object mask, without
    replacement within each pass over it; None when the mask holds fewer
    than valid_pix_cnt_th pixels (the caller resamples)."""
    valid_pos = msk_noc_small.nonzero()
    valid_cnt = len(valid_pos[0])
    if valid_cnt < valid_pix_cnt_th:
        return None
    sel, idx_chunks = 0, []
    while sel < CHECK_PT_CNT:
        n_new = min(valid_cnt, CHECK_PT_CNT - sel)
        sel += n_new
        idx_chunks.append(rng.choice(valid_cnt, n_new, replace=False))
    ck = np.concatenate(idx_chunks)
    return np.stack((valid_pos[1][ck], valid_pos[0][ck]), -1).astype(np.int32)


class BOPDataset:
    """Host-side sample assembly from a BOP tree, for one (cfg_dataset,
    train) pair."""

    def __init__(self, cfg_dataset, cfg_global, train: bool = True):
        import cv2
        self._cv2 = cv2
        cv2.setNumThreads(0)
        self.cfg = cfg_dataset
        self.training = train

        annots = []
        for list_file in cfg_dataset.list_files:
            annots.extend(bop.load_annots_from_image_list(
                list_file, cfg_dataset.dataset_root, flatten=True,
                visib_fract_th=max(cfg_dataset.get('visib_frac', 0), 0),
                obj_ids=cfg_global.get('obj_ids'),
                cache_dir=cfg_global.get('cache_dir', ''),
                gt_keys=['bbox_visib']))
        if not train and cfg_dataset.get('detection'):
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
        max_bit_cnt = cfg_global.get('max_bit_cnt', 0)
        if max_bit_cnt > 0:
            oid = annots[0][1]['obj_id']
            if any(a[1]['obj_id'] != oid for a in annots):
                raise ValueError('binary mode only allowed in single object '
                                 'mode')
            self.bit_cnt = tuple(calc_bit_count(
                self.model_info[oid]['noc_scale_xfd'].tolist(),
                max_bits=max_bit_cnt))
        # model keypoints of the sparse head, from the FPS pickle
        self.sparse_cnt = cfg_global.get('sparse_cnt', 0)
        self.fps = None
        if self.sparse_cnt > 0:
            with open(cfg_global.fps, 'rb') as f:
                self.fps = pickle.load(f)

        self.sym_obj_ids = []
        if cfg_global.get('sym_aware', cfg_dataset.get('sym_aware', False)):
            ids = DATASET_SYMMETRIC_OBJ_IDS.get(cfg_dataset.get('name'))
            if ids is None:
                raise RuntimeError(
                    f'dataset name not found: {cfg_dataset.get("name")}')
            self.sym_obj_ids = ids
        # the candidate count every sample is padded to
        self.max_candidates = 1
        for oid in {a[1]['obj_id'] for a in annots} & set(self.sym_obj_ids):
            info = self.model_info[oid]
            k = 1 + len(info['symmetries_discrete']) \
                if 'symmetries_discrete' in info \
                else 384 if 'symmetries_continuous' in info else 1
            self.max_candidates = max(self.max_candidates, k)

        self.transform_model = cfg_global.get('transform_model', False)
        self.valid_pix_cnt_th = cfg_dataset.get('valid_pix_cnt_th', 100)
        self.net_input_wh = tuple(cfg_global.get(
            'net_input_wh', cfg_dataset.get('net_input_wh', (256, 256))))
        self.net_output_wh = tuple(cfg_global.get(
            'net_output_wh', cfg_dataset.get('net_output_wh', (64, 64))))
        self.mask_nearest = \
            cfg_dataset.get('mask_interp', 'linear').lower() == 'nearest'
        # dataloader.device_rotate: the rotated RGB (and mask) crop runs on
        # the card through the shear kernel; the host ships full frames
        self.device_rotate = bool(train and cfg_global.get(
            'dataloader', {}).get('device_rotate', False))
        # otherwise rotated crops are warped on the host with cv2
        self.host_warp = train and cfg_dataset.get('rotate_prob', 0) > 0 \
            and not self.device_rotate
        self.bg_list = None
        if train and cfg_dataset.get('bg_dir') and osp.isdir(cfg_dataset.bg_dir):
            self.bg_list = sorted(osp.join(cfg_dataset.bg_dir, f)
                                  for f in os.listdir(cfg_dataset.bg_dir))

    def __len__(self):
        return len(self.annots)

    def _read_mask(self, im_info, inst_info):
        path = osp.join(self.cfg.dataset_root, bop.mask_path(im_info, inst_info))
        m = self._cv2.imread(path, self._cv2.IMREAD_GRAYSCALE)
        if m is None:
            raise FileNotFoundError(path)
        return (m > 127).astype(np.float32)

    def _homo_z_full(self, im_info, inst_info, size_hw):
        """gzip z_crop -> the full-image (u·z, v·z, z) map (reference
        dataset.py:287-311), through native/liblcdata.so when built."""
        from . import native
        path = osp.join(self.cfg.dataset_root,
                        bop.z_crop_path(im_info, inst_info))
        with gzip.open(path, 'rb') as f:
            zi = pickle.load(f)
        if zi['z_max'] == 0:
            raise RuntimeError('no target in ROI')
        homo_z, _ = native.zcrop_expand(zi['z_crop'], zi['xyxy'],
                                        float(zi['z_min']), float(zi['z_max']),
                                        size_hw)
        return homo_z

    def sample(self, index: int, rng: np.random.Generator | None = None):
        """One host blob. A training sample draws from `rng` and is None
        when its crop holds too few object pixels (the caller resamples)."""
        cv2 = self._cv2
        im_info, inst_info = self.annots[index]
        cfg = self.cfg
        bgr = cv2.imread(osp.join(cfg.dataset_root, im_info['rgb']),
                         cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(im_info['rgb'])
        rgb = np.ascontiguousarray(bgr[..., ::-1])
        obj_id = inst_info['obj_id']
        if not self.training:
            bbox = inst_info.get('bbox_det')
            if bbox is None:
                bbox = inst_info['bbox_visib']
            return self._object_keys(eval_blob(
                rgb, im_info['cam_K'], bbox, self.model_info[obj_id],
                obj_id=obj_id, im_id=im_info['im_id'],
                scene_id=im_info['scene_id'], net_input_wh=self.net_input_wh,
                net_output_wh=self.net_output_wh,
                dzi_pad_scale=cfg.dzi_pad_scale,
                det_score=inst_info.get('det_score', 1.0)), obj_id)

        H, W = rgb.shape[:2]
        cam_K = im_info['cam_K']
        R = inst_info['cam_R_m2c']
        t = inst_info['cam_t_m2c'][..., 0]
        m_info = self.model_info[obj_id]
        msk_visib = self._read_mask(im_info, inst_info)
        homo_z = self._homo_z_full(im_info, inst_info, (H, W))
        bbox_xywh = inst_info['bbox_visib']
        bbox_xyxy = np.concatenate((bbox_xywh[:2], bbox_xywh[:2] + bbox_xywh[2:]))
        center, scale = aug_bbox(bbox_xyxy, H, W, rng, cfg)
        rotate = rng.random() * 4 * math.pi \
            if rng.random() < cfg.get('rotate_prob', 0) else 0.0

        out_wh, in_wh = self.net_output_wh, self.net_input_wh
        out_aff = crop_affine(center, scale, rotate, out_wh).astype(np.float32)
        in_aff = crop_affine(center, scale, rotate, in_wh).astype(np.float32)
        with_bg = bool(self.bg_list)
        vis_flag = cv2.INTER_NEAREST if self.mask_nearest else cv2.INTER_LINEAR
        if self.host_warp:
            blob = {
                'rgb_in': cv2.warpAffine(rgb, in_aff, in_wh,
                                         flags=cv2.INTER_LINEAR).astype(np.uint8),
                'msk_vis_small': cv2.warpAffine(
                    msk_visib, out_aff, out_wh, flags=vis_flag).astype(np.float32),
            }
            if with_bg:
                blob['msk_in'] = (cv2.warpAffine(
                    msk_visib, in_aff, in_wh, flags=cv2.INTER_LINEAR)
                    * 255).astype(np.uint8)
        elif self.device_rotate:
            blob = {
                'rgb_full': rgb,
                'crop_center': center.astype(np.float32),
                'crop_scale': np.float32(scale),
                'crop_rot': np.float32(rotate),
                'msk_vis_small': cv2.warpAffine(
                    msk_visib, out_aff, out_wh, flags=vis_flag).astype(np.float32),
            }
            if with_bg:
                blob['msk_full'] = (msk_visib * 255).astype(np.uint8)
        else:
            blob = {'rgb_full': rgb,
                    'msk_full': (msk_visib * 255).astype(np.uint8),
                    'in_affine': in_aff}
        blob.update({
            'out_affine': out_aff,
            'out_K': (affine33(out_aff) @ cam_K).astype(np.float32),
            'noc_scale': m_info['noc_scale_xfd'].astype(np.float32),
            'noc_scale_ori': m_info['noc_scale_ori'].astype(np.float32),
            'out_pix_scale': np.float32(scale / out_wh[0]),
            'obj_id': np.int32(obj_id),
            'im_id': np.int32(im_info['im_id']),
            'scene_id': np.int32(im_info['scene_id']),
        })
        self._object_keys(blob, obj_id)

        msk_noc_small = cv2.warpAffine(msk_visib, out_aff, out_wh,
                                       flags=cv2.INTER_NEAREST) > 0.5
        if self.host_warp or self.device_rotate:
            blob['msk_noc_small'] = msk_noc_small.astype(np.float32)
        sym_ck = check_points(msk_noc_small, rng, self.valid_pix_cnt_th)
        if sym_ck is None:
            return None
        homo_z_out = cv2.warpAffine(homo_z, out_aff, out_wh,
                                    flags=cv2.INTER_NEAREST)
        if obj_id in self.sym_obj_ids:
            cands = symmetry_pose_candidates(R, t, m_info)
        else:
            cands = np.concatenate((R, t[:, None]), -1)[None].astype(np.float32)
        cands, cand_valid = pad_candidates(cands, self.max_candidates)
        if with_bg:
            switch_bg = rng.random() < cfg.get('switch_bg_prob', 0)
            blob['switch_bg'] = np.bool_(switch_bg)
            blob['bg_crop'] = (self._random_bg_crop(rng, in_wh) if switch_bg
                               else np.zeros(in_wh[::-1] + (3,), np.uint8))
        blob.update({
            'homo_z_out': homo_z_out.astype(np.float32),
            'K_no_aug': cam_K.astype(np.float32),
            'R_no_aug': R.astype(np.float32),
            't_no_aug': t.astype(np.float32),
            'sym_ck_pts2d': sym_ck,
            'Rt_candi': cands,
            'candi_valid': cand_valid,
            'bbox_3d': m_info['bbox_3d_ori'].astype(np.float32),
            'diameter': np.float32(m_info['diameter']),
            'pixel_aug': np.bool_(rng.random() < cfg.get('pixel_aug_prob', 0)),
        })
        return blob

    def _object_keys(self, blob: dict, obj_id: int) -> dict:
        """The object's keypoints (sparse head) and canonical-frame
        transform (transform_model), added to `blob`."""
        if self.sparse_cnt > 0:
            blob['pts3d'] = np.asarray(self.fps[obj_id][:self.sparse_cnt],
                                       np.float32)
        if self.transform_model:
            blob['model_transform'] = \
                self.model_info[obj_id]['xform'].astype(np.float32)
        return blob

    def _random_bg_crop(self, rng, in_wh):
        """A random resized crop of a random background image
        (reference dataset.py:137-148)."""
        cv2 = self._cv2
        path = self.bg_list[rng.integers(len(self.bg_list))]
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(path)
        bg = np.ascontiguousarray(bgr[..., ::-1])
        bh, bw = bg.shape[:2]
        W, Hh = in_wh
        rw = max(int(rng.random() * bw), W)
        rh = max(int(rng.random() * bh), Hh)
        rl = max(int(rng.random() * (bw - rw)), 0)
        rt = max(int(rng.random() * (bh - rh)), 0)
        return cv2.resize(bg[rt:rt + rh, rl:rl + rw], (W, Hh)).astype(np.uint8)


def collate(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class Loader:
    """Batches of dataset.sample() blobs, assembled by a pool of threads, in
    order, with up to max(prefetch, num_threads) batches in flight.

    Training (the default for a training dataset): the order is shuffled
    per epoch from (seed, epoch), the last partial batch dropped, and a
    sample that comes back None replaced by a random one. Every sample draws
    from np.random.default_rng((seed, epoch, batch index, row)), so the
    stream is a function of its position: a resumed run (set_position)
    repeats the uninterrupted one, whatever the threads do.
    process_index / process_count carve each global batch into this
    process's contiguous slice, its rows drawn from their global positions,
    so the union of the processes' streams is the one-process stream."""

    def __init__(self, dataset, batch_size: int, *, seed: int = 0,
                 shuffle: bool | None = None, num_threads: int = 4,
                 prefetch: int = 2, drop_last: bool | None = None,
                 process_index: int = 0, process_count: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        train = getattr(dataset, 'training', False)
        self.shuffle = train if shuffle is None else shuffle
        self.drop_last = train if drop_last is None else drop_last
        self.seed = seed
        self.num_threads = max(num_threads, 1)
        self.window = max(prefetch, self.num_threads)
        self.epoch = 0
        self._skip = 0
        self.process_index = process_index
        self.process_count = process_count
        _check_carving(batch_size, process_count, self.drop_last)

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def set_position(self, batch_index: int):
        """Resume at a global batch index: the next epoch iterated is
        batch_index // len(self), its first batch_index % len(self) batches
        skipped."""
        if len(self):
            self.epoch, self._skip = divmod(int(batch_index), len(self))

    def _sample_ok(self, idx: int, rng: np.random.Generator) -> dict:
        blob = self.ds.sample(idx, rng)
        while blob is None:
            blob = self.ds.sample(int(rng.integers(len(self.ds))), rng)
        return blob

    def _batch(self, epoch: int, i: int, idxs) -> dict:
        idxs, base = _carve(idxs, self.process_index, self.process_count)
        return collate([self._sample_ok(int(j), np.random.default_rng(
            (self.seed, epoch, i, base + jj))) for jj, j in enumerate(idxs)])

    def __iter__(self):
        epoch = self.epoch
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        self.epoch += 1
        skip, self._skip = self._skip, 0
        bs = self.batch_size
        pending: collections.deque = collections.deque()
        with ThreadPoolExecutor(self.num_threads) as pool:
            try:
                for i in range(skip, len(self)):
                    pending.append(pool.submit(self._batch, epoch, i,
                                               order[i * bs:(i + 1) * bs]))
                    if len(pending) >= self.window:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()


def _check_carving(batch_size: int, process_count: int, drop_last: bool):
    if process_count > 1:
        if batch_size % process_count:
            raise ValueError(f'batch_size {batch_size} not divisible by '
                             f'{process_count} processes')
        if not drop_last:
            raise ValueError('sharded loading requires drop_last')


def _carve(idxs, process_index: int, process_count: int):
    """(this process's slice of a global batch's indices, its first global
    row)."""
    if process_count <= 1:
        return idxs, 0
    per = len(idxs) // process_count
    base = process_index * per
    return idxs[base:base + per], base


# The process-pool loader. Each worker builds one BOPDataset in its
# initializer (the dataset holds module handles and does not pickle) and
# returns collated numpy batches.
_WORKER_DS = None


def _mp_init(cfg_dataset: dict, cfg_global: dict, train: bool):
    global _WORKER_DS
    from ..utils.config import Config
    _WORKER_DS = BOPDataset(Config(cfg_dataset), Config(cfg_global),
                            train=train)


def _mp_make_batch(job) -> dict:
    """One batch: job = (dataset indices, (seed, epoch, batch index), global
    position of the first row). Every row draws from
    default_rng((seed, epoch, i, global row)), as Loader's rows do."""
    idxs, key, base = job
    ds = _WORKER_DS
    samples = []
    for jj, idx in enumerate(idxs):
        rng = np.random.default_rng(key + (base + jj,))
        blob = ds.sample(int(idx), rng)
        while blob is None:
            blob = ds.sample(int(rng.integers(len(ds))), rng)
        samples.append(blob)
    return collate(samples)


class MPLoader:
    """Batches assembled in a pool of worker processes, free of the
    interpreter lock (the reference's eight forked DataLoader workers).

    The stream is the one Loader gives for the same seed: the order is
    shuffled per epoch from (seed, epoch), the last partial batch dropped
    in training, and each row drawn from (seed, epoch, i, global row), so a
    batch is a pure function of its position and `endless(start)` resumes
    bit-identically. process_index / process_count carve each global batch
    into this process's contiguous slice, keyed on global rows.

    The workers start from a fresh interpreter (forkserver), never by a fork
    of the caller, which may hold CUDA state and threads; they get the two
    configs as plain dicts. Up to max(prefetch, num_workers) batches are in
    flight. close() stops the pool."""

    def __init__(self, cfg_dataset, cfg_global, *, batch_size: int,
                 train: bool = True, seed: int = 0, num_workers: int = 8,
                 prefetch: int = 4, shuffle: bool | None = None,
                 drop_last: bool | None = None, process_index: int = 0,
                 process_count: int = 1):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        self.ds = BOPDataset(cfg_dataset, cfg_global, train=train)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = train if shuffle is None else shuffle
        self.drop_last = train if drop_last is None else drop_last
        self.window = max(prefetch, num_workers, 1)
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        _check_carving(batch_size, process_count, self.drop_last)
        ctx = multiprocessing.get_context('forkserver')
        ctx.set_forkserver_preload([__name__])
        self._pool = ProcessPoolExecutor(
            max_workers=max(num_workers, 1), mp_context=ctx,
            initializer=_mp_init,
            initargs=(_plain(cfg_dataset), _plain(cfg_global), train))

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _jobs(self, epoch: int, first: int = 0):
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        bs = self.batch_size
        for i in range(first, len(self)):
            local, base = _carve(order[i * bs:(i + 1) * bs],
                                 self.process_index, self.process_count)
            yield local, (self.seed, epoch, i), base

    def _stream(self, jobs):
        pending: collections.deque = collections.deque()
        try:
            for job in jobs:
                pending.append(self._pool.submit(_mp_make_batch, job))
                if len(pending) >= self.window:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()

    def __iter__(self):
        """One epoch; the shuffle and every row's draws keyed on it."""
        epoch, self.epoch = self.epoch, self.epoch + 1
        return self._stream(self._jobs(epoch))

    def endless(self, start: int = 0):
        """The batches from global batch index `start` on, across epoch
        boundaries with no pause at them."""
        def jobs():
            n = len(self)
            if not n:
                return
            epoch, first = divmod(int(start), n)
            while True:
                yield from self._jobs(epoch, first)
                epoch, first = epoch + 1, 0
        return self._stream(jobs())

    def close(self):
        """Cancel queued batches and stop the worker processes."""
        self._pool.shutdown(wait=True, cancel_futures=True)


def _plain(cfg):
    return cfg.to_dict() if hasattr(cfg, 'to_dict') else dict(cfg)


def device_preprocess(batch: dict, generator: torch.Generator | None = None, *,
                      net_input_wh, net_output_wh=None, mask_nearest=False,
                      use_pepper_salt=False, use_motion_blur=False,
                      use_invert=False, train=False) -> dict:
    """The device stage: crops, background switch, colour augmentation (its
    values drawn from `generator`, on the batch's device; inside a
    data-parallel context for the global batch, of which `batch` holds this
    rank's rows), normalization.
    batch: dict of tensors on the target device, the collated host blobs.
    Returns the gt blob the model and the losses consume."""
    in_hw = (net_input_wh[1], net_input_wh[0])
    host_warped = 'rgb_in' in batch          # rotated crops warped on the host
    device_rot = 'crop_rot' in batch         # dataloader.device_rotate
    if host_warped:
        rgb_in = batch['rgb_in'].to(torch.float32)
    elif device_rot:
        from ..ops.warp import rotated_crop_warp
        rgb_in = rotated_crop_warp(batch['rgb_full'].to(torch.float32),
                                   batch['crop_center'], batch['crop_scale'],
                                   batch['crop_rot'], net_input_wh)
    else:
        # 8-bit RGB: bf16 matmuls, well under one intensity step of error
        rgb_in = batched_separable_warp(batch['rgb_full'].to(torch.float32),
                                        batch['in_affine'], in_hw, 'bilinear',
                                        compute_dtype=torch.bfloat16)
    out = {k: v for k, v in batch.items() if k not in _DEVICE_INPUT_KEYS}
    if train:
        out_hw = (net_output_wh[1], net_output_wh[0])
        if host_warped or device_rot:
            msk_in = batch.get('msk_in')
            if msk_in is not None:
                msk_in = msk_in.to(torch.float32) / 255.0
            elif device_rot and 'msk_full' in batch:
                from ..ops.warp import rotated_crop_warp
                mf = (batch['msk_full'].to(torch.float32) / 255.0)[..., None]
                msk_in = rotated_crop_warp(mf, batch['crop_center'],
                                           batch['crop_scale'],
                                           batch['crop_rot'],
                                           net_input_wh)[..., 0]
            msk_vis = batch['msk_vis_small']
            msk_noc = batch['msk_noc_small'] > 0.5
        else:
            msk_full = (batch['msk_full'].to(torch.float32) / 255.0)[..., None]
            msk_in = batched_separable_warp(msk_full, batch['in_affine'],
                                            in_hw, 'bilinear')[..., 0]
            msk_vis = batched_separable_warp(
                msk_full, batch['out_affine'], out_hw,
                'nearest' if mask_nearest else 'bilinear')[..., 0]
            msk_noc = batched_separable_warp(
                msk_full, batch['out_affine'], out_hw, 'nearest')[..., 0] > 0.5
        if 'bg_crop' in batch:
            rgb_in = switch_background(rgb_in, msk_in,
                                       batch['bg_crop'].to(torch.float32),
                                       batch['switch_bg'])
        auged = color_augment(rgb_in, generator,
                              use_pepper_salt=use_pepper_salt,
                              use_motion_blur=use_motion_blur,
                              use_invert=use_invert)
        rgb_in = torch.where(batch['pixel_aug'][:, None, None, None], auged,
                             rgb_in)
        out['msk_vis'] = msk_vis
        out['msk_noc'] = msk_noc.to(torch.float32)
    dev = rgb_in.device
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    out['img_in'] = (rgb_in / 255.0 - mean) / std
    return out


def device_prefetch(host_batches, preprocess_fn, device, size: int = 2):
    """Stage the next `size` host batches on the device while the caller
    works on the current one (counterpart of lc_tpu's device_prefetch):
    yields preprocess_fn(the batch on `device`, i), i counting the batches
    from 0, the values those of staging each batch when it is taken (size
    0).

    On CUDA a staged batch is copied from pinned host memory and
    preprocessed on a side stream. Before a batch is handed over, the
    caller's stream waits for that work, and every tensor in it is recorded
    on the caller's stream (record_stream), so the allocator reuses none of
    its memory while the caller's stream may still read it. Off CUDA the
    batches are staged ahead in line. The copy is the profiler range
    'h2d'."""
    device = torch.device(device)
    side = torch.cuda.Stream(device) \
        if device.type == 'cuda' and size > 0 else None

    def stage(i, batch):
        if side is None:
            with record_function('h2d'):
                dev = {k: torch.as_tensor(v).to(device)
                       for k, v in batch.items()}
            return preprocess_fn(dev, i), None
        pinned = {k: torch.as_tensor(v).pin_memory() for k, v in batch.items()}
        with torch.cuda.stream(side):
            with record_function('h2d'):
                dev = {k: v.to(device, non_blocking=True)
                       for k, v in pinned.items()}
            out = preprocess_fn(dev, i)
        return out, side.record_event()

    def hand_over(out, done):
        if done is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(done)
            for v in out.values():
                if torch.is_tensor(v) and v.is_cuda:
                    v.record_stream(current)
        return out

    pending: collections.deque = collections.deque()
    for i, batch in enumerate(host_batches):
        pending.append(stage(i, batch))
        if len(pending) > size:
            yield hand_over(*pending.popleft())
    while pending:
        yield hand_over(*pending.popleft())
