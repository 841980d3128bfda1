"""Config -> model/loss/data/evaluator wiring and the test loop (counterpart
of lc_tpu/harness.py, on one device)."""
from __future__ import annotations

import contextlib
import copy
import logging
import time

import numpy as np
import torch

from . import inference, resolve_device
from .data.pipeline import BOPDataset, Loader, MPLoader, device_preprocess
from .eval.evaluator import Evaluator, gen_score_table
from .geom.pose import pose7_to_RT
from .loss.loss_fn import LossConfig
from .models import build_model, default_compute_dtype, quant, \
    set_compute_dtype
from .parallel import mesh

logger = logging.getLogger(__name__)


def make_loss_config(cfg, steps_per_epoch: int, bit_cnt) -> LossConfig:
    """The loss hyperparameters of `cfg`; bit_cnt is the training set's
    (BOPDataset.bit_cnt: None but for the Gray-code head)."""
    lc = cfg.loss
    pose_cfg = lc.get('pose_loss_cfg', {})
    full = max(lc.get('pose_loss_start_step', 0),
               lc.get('pose_loss_start_epoch', 0) * steps_per_epoch)
    return LossConfig(
        w_loss_noc=lc.get('w_loss_noc', 0.0),
        w_loss_noc_bin=lc.get('w_loss_noc_bin', 0.0),
        w_loss_seg=lc.get('w_loss_seg', 0.0),
        w_loss_pose=lc.get('w_loss_pose', 0.0),
        w_loss_kpts=lc.get('w_loss_kpts', 0.0),
        seg_loss_type=lc.get('seg_loss_type', 'BCE').lower(),
        full_pose_loss_step=int(full),
        loss_pose_nz_step=lc.get('loss_pose_nz_step', 0),
        dense_sample=pose_cfg.get('dense_sample', 2),
        max_err_len=pose_cfg.get('max_err_len', 32),
        cov_2d=pose_cfg.get('cov_2d', False),
        clip_weight_grad=pose_cfg.get('clip_weight_grad', True),
        clip_scale_grad=pose_cfg.get('clip_scale_grad', False),
        clip_pts_grad=pose_cfg.get('clip_pts_grad', False),
        bit_cnt=tuple(bit_cnt) if bit_cnt else None,
        black_background=cfg.get('black_background', False),
        sparse=cfg.get('sparse_cnt', 0) > 3,
    )


def build_model_from_cfg(cfg, total_bit_cnt: int = 0):
    return build_model(cfg.model.net_name, dict(cfg.model.get('net_config', {})),
                       sparse_cnt=cfg.get('sparse_cnt', 0),
                       total_bit_cnt=total_bit_cnt)


def make_datasets(cfg, train: bool = True, seed: int = 0,
                  process_index: int = 0, process_count: int = 1):
    """(dataset, loader) of the training or the test split. Training loaders
    shuffle and drop the last partial batch; under dataloader.multiprocess
    the training loader is an MPLoader (worker processes, num_workers of
    them, 8 by default). With train_dataset_1 the
    training loader is a RatioMixLoader: int(batch · ratio) crops of each
    batch from train_dataset_1 (its missing keys taken from train_dataset),
    the rest from train_dataset, each sub-loader on half the threads with
    seeds seed and seed + 1 (reference utils.py:79-147, MultiLoader); the
    dataset returned is train_dataset's. A training loader yields the
    process_index-th of process_count contiguous slices of each global
    batch (each sub-stream's, under train_dataset_1); the test loader
    yields whole batches (run_test shards them)."""
    batch = cfg.dataloader.batch_size
    proc = dict(process_index=process_index,
                process_count=process_count) if train else {}
    if train and 'train_dataset_1' in cfg:
        d1_cfg = copy.deepcopy(cfg.train_dataset_1)
        for k, v in cfg.train_dataset.items():
            if k not in d1_cfg:
                d1_cfg[k] = v
        b1 = int(batch * cfg.train_dataset_1.ratio)
        if process_count > 1 and (b1 % process_count
                                  or (batch - b1) % process_count):
            # each sub-stream is carved on its own, so both sub-batches
            # must divide: stricter than batch_size alone
            raise ValueError(
                f'ratio-mixed sharded loading: sub-batches {b1} and '
                f'{batch - b1} (batch_size {batch} x ratio '
                f'{cfg.train_dataset_1.ratio}) must each be divisible by '
                f'{process_count} processes')
        ds1 = BOPDataset(d1_cfg, cfg, train=True)
        ds0 = BOPDataset(cfg.train_dataset, cfg, train=True)
        nw = max(cfg.dataloader.get('num_workers', 4) // 2, 1)
        return ds0, RatioMixLoader(
            Loader(ds0, batch - b1, seed=seed + 1, num_threads=nw, **proc),
            Loader(ds1, b1, seed=seed, num_threads=nw, **proc))
    if train and cfg.dataloader.get('multiprocess', False):
        loader = MPLoader(cfg.train_dataset, cfg, batch_size=batch,
                          train=True, seed=seed,
                          num_workers=cfg.dataloader.get('num_workers', 8),
                          **proc)
        return loader.ds, loader
    ds = BOPDataset(cfg.train_dataset if train else cfg.test_dataset, cfg,
                    train=train)
    loader = Loader(ds, batch, seed=seed, shuffle=train, drop_last=train,
                    num_threads=cfg.dataloader.get('num_workers', 4), **proc)
    return ds, loader


class RatioMixLoader:
    """Endless mixer of two loaders into one batch (real + PBR ratio
    mixing): each batch is loader0's next batch followed by loader1's, each
    sub-stream restarting at its own end. Rt_candi and candi_valid are
    padded to the larger candidate count (repeats of the first candidate,
    not valid), so the two streams may differ in their symmetries."""

    def __init__(self, loader0: Loader, loader1: Loader):
        self.loaders = (loader0, loader1)
        self.iters = [iter(loader0), iter(loader1)]

    def __len__(self):
        return max(len(x) for x in self.loaders)

    def set_position(self, batch_index: int):
        """Resume at a mixed-batch index: each sub-loader has consumed that
        many of its own batches."""
        for x in self.loaders:
            x.set_position(batch_index)
        self.iters = [iter(x) for x in self.loaders]

    def _next(self, which: int) -> dict:
        try:
            return next(self.iters[which])
        except StopIteration:
            self.iters[which] = iter(self.loaders[which])
            return next(self.iters[which])

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b0, b1 = self._next(0), self._next(1)
        out = {}
        for k in b0:
            a, b = b0[k], b1[k]
            if k in ('Rt_candi', 'candi_valid') \
                    and a.shape[1] != b.shape[1]:
                a, b = (_pad_candidates(x, max(a.shape[1], b.shape[1]),
                                        k == 'candi_valid') for x in (a, b))
            out[k] = np.concatenate((a, b), 0)
        return out


def _pad_candidates(x: np.ndarray, k: int, is_mask: bool) -> np.ndarray:
    pad = np.zeros_like(x[:, :1]) if is_mask else x[:, :1]
    return np.concatenate((x, np.repeat(pad, k - x.shape[1], 1)), 1)


def preprocess_kwargs(cfg, dataset, train: bool) -> dict:
    ds_cfg = cfg.train_dataset if train else cfg.test_dataset
    return dict(
        net_input_wh=tuple(dataset.net_input_wh),
        net_output_wh=tuple(dataset.net_output_wh),
        mask_nearest=dataset.mask_nearest,
        use_pepper_salt=ds_cfg.get('use_peper_salt', False),
        use_motion_blur=ds_cfg.get('use_motion_blur', False),
        use_invert=ds_cfg.get('use_invert', False),
        train=train,
    )


def get_evaluator(cfg, device='cpu') -> Evaluator:
    ds = cfg.test_dataset
    return Evaluator.from_bop(list(ds.list_files), ds.dataset_root,
                              ds.get('name'),
                              eval_model_dir=ds.get('eval_model_dir'),
                              obj_ids=cfg.get('obj_ids'),
                              use_eval_model=ds.get('use_eval_model', True),
                              visib_fract_th=ds.visib_frac, device=device)


def run_test(cfg, model, loader, dataset, evaluator,
             score_key: str = 'add(-s)_0.10', seed: int = 0,
             device=None) -> dict:
    """Full inference + evaluation pass.

    loader yields host batches (dicts of numpy arrays, the eval blobs of
    data/pipeline.py collated); dataset provides net_input_wh and bit_cnt.
    The dense heads (continuous NOC or Gray codes) go through
    inference.solve_pnp_dense, the sparse head (sparse_cnt > 3) through
    solve_pnp_sparse. With int8_inference the CNN's convolutions run in
    int8 (models/quant.py): int8_act_scales 'dynamic' (per-sample scales)
    or 'static' (scales calibrated on the first batch, then fixed); decode,
    RANSAC and LM are unchanged.
    Runs on `device`: CUDA unless 'cpu' is passed. Inside a data-parallel
    context (parallel/mesh.py) the pass is sharded as lc_tpu's is over its
    mesh: each eval batch is padded to a multiple of the number of ranks
    (its last crop repeated), each rank runs the CNN and the solve on its
    contiguous rows, and the poses are gathered in rank order on every
    rank, the padded rows dropped. The RANSAC draws are made for the global
    batch and sliced, so each crop sees the same draws at any number of
    ranks; static int8 scales are the max over the ranks, the global
    batch's. Every rank returns the same results. Returns
    {solver: dict(avg_score, per_obj_score, errors, tables)}."""
    device = resolve_device(device)
    shard = mesh.active()
    int8 = bool(cfg.get('int8_inference', False))
    act_mode = str(cfg.get('int8_act_scales', 'dynamic'))
    if int8 and act_mode not in ('dynamic', 'static'):
        raise ValueError(f'int8_act_scales must be dynamic or static, not '
                         f'{act_mode!r}')
    solver_cfg = cfg.pnp_solver
    sparse = cfg.get('sparse_cnt', 0) > 3
    model = set_compute_dtype(model.to(device).eval(),
                              default_compute_dtype(device))
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    results: dict[str, list] = {}
    total_time = 0.0
    n_insts = 0
    first_time = first_insts = None
    act_scales = None
    for batch in loader:
        t_start = time.perf_counter()
        n_valid = len(batch['im_id'])
        local = batch
        if shard is not None:
            padded, _ = mesh.pad_to_multiple(batch, shard.count)
            local = {k: mesh.local_rows(v, shard) for k, v in padded.items()}
        dev_batch = {k: torch.as_tensor(v).to(device)
                     for k, v in local.items()}
        gt = device_preprocess(dev_batch, net_input_wh=dataset.net_input_wh)
        with torch.no_grad():
            if int8 and act_mode == 'static' and act_scales is None:
                # static scales, calibrated on the first batch
                act_scales = quant.calibrate_act_scales(model,
                                                        [gt['img_in']])
                if shard is not None:
                    names = sorted(act_scales)
                    amax = mesh.all_reduce_max(torch.stack(
                        [act_scales[k] for k in names]), shard)
                    act_scales = dict(zip(names, amax.unbind()))
            with quant.quantized_int8(model, act_scales=act_scales) \
                    if int8 else contextlib.nullcontext():
                out = model(gt['img_in'])
        thr = None
        if solver_cfg.get('rel_reproj_err', False):
            # 2 px at full-image scale
            thr = torch.as_tensor(2.0 / np.asarray(local['out_pix_scale']),
                                  dtype=torch.float32, device=device)
        if sparse:
            states = inference.solve_pnp_sparse(
                out, gt, generator, solvers=tuple(solver_cfg.solvers),
                reproj_err=thr, device=device, global_rows=n_valid)
        else:
            states = inference.solve_pnp_dense(
                out, gt, generator, bit_cnt=dataset.bit_cnt,
                black_background=cfg.get('black_background', False),
                sample=solver_cfg.get('dense_sample', 2),
                point_select=solver_cfg.get('dense_point_select', 'quantile'),
                quantile=solver_cfg.get('quantile', 0.3),
                seg_thresh=solver_cfg.get('seg_thresh', 0.5),
                solvers=tuple(solver_cfg.solvers), reproj_err=thr,
                device=device, global_rows=n_valid)
        host = {}
        for name, pose7 in states.items():
            R, t = pose7_to_RT(mesh.gather_rows(pose7, shard)[:n_valid])
            host[name] = (R.cpu().numpy(), t.cpu().numpy())   # syncs the device
        batch_time = time.perf_counter() - t_start
        total_time += batch_time
        n_insts += n_valid
        if first_time is None:
            first_time, first_insts = batch_time, n_valid
        scores = batch.get('det_score', np.ones(n_valid, np.float32))
        for name, (R, t) in host.items():
            lst = results.setdefault(name, [])
            for i in range(n_valid):
                lst.append(dict(obj_id=int(batch['obj_id'][i]),
                                im_id=int(batch['im_id'][i]),
                                scene_id=int(batch['scene_id'][i]),
                                R_est=R[i], t_est=t[i], score=float(scores[i])))

    # BOP 'time': one steady-state mean wall time per instance, excluding the
    # first batch (warm-up); the all-batches mean on a single-batch run
    if first_time is not None and n_insts > first_insts:
        mean_time = (total_time - first_time) / (n_insts - first_insts)
    else:
        mean_time = total_time / max(n_insts, 1)
    for lst in results.values():
        for r in lst:
            r['time'] = mean_time

    outputs = {}
    for name, res in results.items():
        per_obj, errors = evaluator.evaluate(
            res, bop=bool(cfg.get('eval_bop_scores', False)))
        tables = gen_score_table(per_obj, dataset_name=evaluator.dataset_name)
        avg = sum(d[score_key] for d in per_obj.values()) / max(len(per_obj), 1)
        outputs[name] = dict(avg_score=avg, per_obj_score=per_obj,
                             errors=errors, tables=tables)
        logger.info('solver %s: %s = %.4f', name, score_key, avg)
    return outputs
