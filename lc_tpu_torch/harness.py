"""Config -> model/loss/data/evaluator wiring and the test loop (counterpart
of lc_tpu/harness.py, on one device)."""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from . import inference, resolve_device
from .data.pipeline import BOPDataset, Loader, device_preprocess
from .eval.evaluator import Evaluator, gen_score_table
from .geom.pose import pose7_to_RT
from .loss.loss_fn import LossConfig
from .models import build_model, default_compute_dtype, set_compute_dtype

logger = logging.getLogger(__name__)


def make_loss_config(cfg, steps_per_epoch: int, bit_cnt=None) -> LossConfig:
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


def make_datasets(cfg, train: bool = True, seed: int = 0):
    """(dataset, loader) of the training or the test split. Training loaders
    shuffle and drop the last partial batch."""
    if train and 'train_dataset_1' in cfg:
        raise NotImplementedError('RatioMixLoader (train_dataset_1) is not '
                                  'ported yet')
    if train and cfg.dataloader.get('multiprocess', False):
        raise NotImplementedError('MPLoader (dataloader.multiprocess) is not '
                                  'ported yet')
    ds = BOPDataset(cfg.train_dataset if train else cfg.test_dataset, cfg,
                    train=train)
    loader = Loader(ds, cfg.dataloader.batch_size, seed=seed, shuffle=train,
                    drop_last=train,
                    num_threads=cfg.dataloader.get('num_workers', 4))
    return ds, loader


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
    """Full inference + evaluation pass on one device.

    loader yields host batches (dicts of numpy arrays, the eval blobs of
    data/pipeline.py collated); dataset provides net_input_wh and bit_cnt.
    The dense heads (continuous NOC or Gray codes) go through
    inference.solve_pnp_dense, the sparse head (sparse_cnt > 3) through
    solve_pnp_sparse.
    Runs on `device`: CUDA unless 'cpu' is passed. Returns
    {solver: dict(avg_score, per_obj_score, errors, tables)}."""
    device = resolve_device(device)
    if cfg.get('int8_inference', False):
        raise NotImplementedError('int8 inference is not ported yet')
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
    for batch in loader:
        t_start = time.perf_counter()
        n_valid = len(batch['im_id'])
        dev_batch = {k: torch.as_tensor(v).to(device)
                     for k, v in batch.items()}
        gt = device_preprocess(dev_batch, net_input_wh=dataset.net_input_wh)
        with torch.no_grad():
            out = model(gt['img_in'])
        thr = None
        if solver_cfg.get('rel_reproj_err', False):
            # 2 px at full-image scale
            thr = torch.as_tensor(2.0 / np.asarray(batch['out_pix_scale']),
                                  dtype=torch.float32, device=device)
        if sparse:
            states = inference.solve_pnp_sparse(
                out, gt, generator, solvers=tuple(solver_cfg.solvers),
                reproj_err=thr, device=device)
        else:
            states = inference.solve_pnp_dense(
                out, gt, generator, bit_cnt=dataset.bit_cnt,
                black_background=cfg.get('black_background', False),
                sample=solver_cfg.get('dense_sample', 2),
                point_select=solver_cfg.get('dense_point_select', 'quantile'),
                quantile=solver_cfg.get('quantile', 0.3),
                seg_thresh=solver_cfg.get('seg_thresh', 0.5),
                solvers=tuple(solver_cfg.solvers), reproj_err=thr,
                device=device)
        host = {}
        for name, pose7 in states.items():
            R, t = pose7_to_RT(pose7)
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
