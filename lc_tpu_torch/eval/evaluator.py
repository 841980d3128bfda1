"""ADD(-S) / AUC evaluation against BOP ground truth (counterpart of
lc_tpu/eval/evaluator.py).

GT records come from a BOP tree (`Evaluator.from_bop`) or straight from
memory (`Evaluator(gts, models, models_info)`), so a run needs no files on
disk. Estimates match GT by (scene_id, im_id, obj_id); per-object add / adi /
re / te come from one batched pass (error6d.batched_pose_errors), and with
bop=True the BOP'19 mssd / mspd and their average recalls.
"""
from __future__ import annotations

import copy
import json
import os.path as osp
import sys
from collections import defaultdict

import numpy as np
import torch

from .error6d import batched_pose_errors, mspd_err, mssd_err
from .ply import load_ply_vertices
from ..data import bop
from ..geom.symmetry import DATASET_SYMMETRIC_OBJ_IDS

LM_OBJ_NAMES = {1: "ape", 2: "benchvise", 3: "bowl", 4: "camera", 5: "can",
                6: "cat", 7: "cup", 8: "driller", 9: "duck", 10: "eggbox",
                11: "glue", 12: "holepuncher", 13: "iron", 14: "lamp",
                15: "phone"}
YCBV_OBJ_NAMES = {
    1: "002_master_chef_can", 2: "003_cracker_box", 3: "004_sugar_box",
    4: "005_tomato_soup_can", 5: "006_mustard_bottle", 6: "007_tuna_fish_can",
    7: "008_pudding_box", 8: "009_gelatin_box", 9: "010_potted_meat_can",
    10: "011_banana", 11: "019_pitcher_base", 12: "021_bleach_cleanser",
    13: "024_bowl", 14: "025_mug", 15: "035_power_drill", 16: "036_wood_block",
    17: "037_scissors", 18: "040_large_marker", 19: "051_large_clamp",
    20: "052_extra_large_clamp", 21: "061_foam_brick"}
DATASET_OBJ_NAMES = {'lm': LM_OBJ_NAMES, 'lmo': LM_OBJ_NAMES,
                     'ycbv': YCBV_OBJ_NAMES, 'ycbvposecnn': YCBV_OBJ_NAMES}


def compute_auc_posecnn(errors: np.ndarray) -> float:
    """PoseCNN-style AUC of the error-vs-recall curve up to 0.1 m (errors in mm)."""
    errors = np.sort(np.asarray(errors, np.float64)) * 1e-3
    d = errors.copy()
    d[d > 0.1] = np.inf
    acc = np.cumsum(np.ones_like(d)) / len(d)
    valid = np.isfinite(d)
    if valid.sum() == 0:
        return float('nan')
    rec = d[valid]
    prec = acc[valid]
    mrec = np.concatenate(([0.0], rec, [0.1]))
    mpre = np.concatenate(([0.0], prec, [prec[-1]]))
    for i in range(1, len(mpre)):
        mpre[i] = max(mpre[i], mpre[i - 1])
    ids = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(((mrec[ids] - mrec[ids - 1]) * mpre[ids]).sum() * 10)


class Evaluator:
    def __init__(self, gts: list[dict], models: dict, models_info: dict,
                 dataset_name: str | None = None, symmetric_obj_ids=None,
                 device='cpu'):
        """gts: one record per GT instance with scene_id, im_id, obj_id,
        R_gt (3, 3), t_gt (3, 1), cam_K and im_w; models: obj_id -> model
        points (N, 3); models_info: obj_id -> info with 'diameter'."""
        self.gts = [dict(score=0, R_est=None, t_est=None,
                         time_est=sys.float_info.max, add=sys.float_info.max,
                         adi=sys.float_info.max, re=sys.float_info.max,
                         te=sys.float_info.max, **g) for g in gts]
        self.models = models
        self.models_info = models_info
        self.dataset_name = dataset_name
        self.symmetric_obj_ids = symmetric_obj_ids
        self.device = device

    @classmethod
    def from_bop(cls, file_lists, dataset_root, dataset_name,
                 eval_model_dir=None, obj_ids=None, symmetric_obj_ids=None,
                 use_eval_model=True, visib_fract_th=0, device='cpu'):
        """GT and model points read from a BOP tree."""
        if eval_model_dir is None:
            eval_model_dir = osp.join(
                dataset_root, 'models_eval' if use_eval_model else 'models')
        if isinstance(file_lists, str):
            file_lists = [file_lists]
        records = []
        for fl in file_lists:
            records.extend(bop.load_annots_from_image_list(
                fl, dataset_root, flatten=False,
                visib_fract_th=visib_fract_th, cache_dir=''))
        with open(osp.join(eval_model_dir, 'models_info.json')) as f:
            models_info = {int(k): v for k, v in json.load(f).items()}
        id_ok = (lambda i: i in set(obj_ids)) if obj_ids is not None \
            else (lambda i: True)
        models = {k: load_ply_vertices(
            osp.join(eval_model_dir, f'obj_{k:06d}.ply'))
            for k in models_info if id_ok(k)}
        gts = [dict(scene_id=im['scene_id'], im_id=im['im_id'],
                    obj_id=inst['obj_id'], R_gt=inst['cam_R_m2c'],
                    t_gt=inst['cam_t_m2c'],
                    cam_K=np.asarray(im['cam_K'], np.float32).reshape(3, 3),
                    im_w=float(im['im_wh'][0]))
               for im, insts in records for inst in insts
               if id_ok(inst['obj_id'])]
        return cls(gts, models, models_info, dataset_name, symmetric_obj_ids,
                   device)

    def match_results_to_gt(self, results):
        gts = copy.deepcopy(self.gts)
        rmap = {(r['scene_id'], r['im_id'], r['obj_id']): r for r in results}
        for gt in gts:
            res = rmap.pop((gt['scene_id'], gt['im_id'], gt['obj_id']), None)
            if res is not None:
                gt.update(res)
        return gts

    def compute_errors(self, matched):
        """Per-object batched errors; unmatched GT keeps the max-float
        sentinels (a miss)."""
        by_obj = defaultdict(list)
        for i, g in enumerate(matched):
            if g['R_est'] is not None:
                by_obj[g['obj_id']].append(i)
        for oid, idxs in by_obj.items():
            stack = lambda k, shape: np.stack(  # noqa: E731
                [np.asarray(matched[i][k], np.float32).reshape(shape)
                 for i in idxs])
            errs = batched_pose_errors(
                stack('R_est', (3, 3)), stack('t_est', (3,)),
                stack('R_gt', (3, 3)), stack('t_gt', (3,)), self.models[oid],
                device=self.device)
            for j, i in enumerate(idxs):
                for k in ('add', 'adi', 're', 'te'):
                    matched[i][k] = float(errs[k][j])
        return matched

    def _sym_transforms(self, oid, max_sym_disc_step=0.01):
        """The object's BOP symmetry set (the BOP toolkit's
        get_symmetry_transformations): the identity and the discrete
        symmetries, each composed with the continuous ones discretized at
        max_sym_disc_step (the pure identity is then not in the set).
        Returns (Rs (S, 3, 3), ts (S, 3)) in f32."""
        info = self.models_info[oid]
        disc = [(np.eye(3), np.zeros(3))]
        for m in info.get('symmetries_discrete', []):
            M = np.asarray(m, np.float64).reshape(4, 4)
            disc.append((M[:3, :3], M[:3, 3]))
        cont = []
        for c in info.get('symmetries_continuous', []):
            axis = np.asarray(c['axis'], np.float64)
            axis = axis / np.linalg.norm(axis)
            offset = np.asarray(c.get('offset', [0, 0, 0]), np.float64)
            n_steps = int(np.ceil(np.pi / max_sym_disc_step))
            for i in range(1, n_steps):
                R = _axis_angle(axis, 2 * np.pi * i / n_steps)
                cont.append((R, offset - R @ offset))
        out = [(Rc @ Rd, Rc @ td + tc) for Rd, td in disc
               for Rc, tc in cont] if cont else disc
        return (np.stack([o[0] for o in out]).astype(np.float32),
                np.stack([o[1] for o in out]).astype(np.float32))

    def compute_bop_errors(self, matched, max_sym_disc_step=0.01,
                           chunk=16):
        """Adds BOP'19 mssd / mspd to every matched instance, computed on
        the evaluator's device in chunks of instances; unmatched GT keeps
        the max-float sentinel (a miss)."""
        by_obj = defaultdict(list)
        for i, g in enumerate(matched):
            g['mssd'] = sys.float_info.max
            g['mspd'] = sys.float_info.max
            if g['R_est'] is not None:
                by_obj[g['obj_id']].append(i)
        as_t = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=self.device)
        for oid, idxs in by_obj.items():
            pts = as_t(self.models[oid])
            sym_R, sym_t = (as_t(a) for a in
                            self._sym_transforms(oid, max_sym_disc_step))
            for c0 in range(0, len(idxs), chunk):
                sub = idxs[c0:c0 + chunk]

                def get(k, shape):
                    return as_t(np.stack([np.asarray(
                        matched[i][k], np.float32).reshape(shape)
                        for i in sub]))
                R_e, t_e = get('R_est', (3, 3)), get('t_est', (3,))
                R_g, t_g = get('R_gt', (3, 3)), get('t_gt', (3,))
                K = get('cam_K', (3, 3))
                ms = mssd_err(R_e, t_e, R_g, t_g, pts, sym_R, sym_t).cpu()
                mp = mspd_err(R_e, t_e, R_g, t_g, K, pts, sym_R, sym_t).cpu()
                for j, i in enumerate(sub):
                    matched[i]['mssd'] = float(ms[j])
                    matched[i]['mspd'] = float(mp[j])
        return matched

    def evaluate(self, outputs, errors=None, bop=False):
        """Per-object scores and the matched errors; bop=True adds the
        BOP'19 mssd / mspd and their average recalls."""
        if errors is None:
            errors = self.compute_errors(self.match_results_to_gt(outputs))
            if bop:
                errors = self.compute_bop_errors(errors)
        if self.symmetric_obj_ids is not None:
            sym_ids = self.symmetric_obj_ids
        elif self.dataset_name is not None:
            sym_ids = DATASET_SYMMETRIC_OBJ_IDS[self.dataset_name]
        else:
            sym_ids = []
        return self.compute_scores(errors, sym_ids), errors

    def compute_scores(self, all_errors, symmetric_obj_ids):
        sym = set(symmetric_obj_ids)
        per_obj = defaultdict(list)
        for e in all_errors:
            per_obj[e['obj_id']].append(e)
        out = {}
        for oid in sorted(per_obj):
            errs = per_obj[oid]
            diameter = self.models_info[oid]['diameter']
            add_v = np.array([e['add'] for e in errs])
            adi_v = np.array([e['adi'] for e in errs])
            ad_v = adi_v if oid in sym else add_v
            n = len(ad_v)
            max_cm = 10
            sd = {
                f'AUCadi_{max_cm}_p11': float(np.mean(
                    [(adi_v < (i + 1) * 10).sum() / n for i in range(max_cm)])),
                f'AUCad_{max_cm}_p11': float(np.mean(
                    [(ad_v < (i + 1) * 10).sum() / n for i in range(max_cm)])),
                f'AUCadi_{max_cm}_all': compute_auc_posecnn(adi_v),
                f'AUCad_{max_cm}_all': compute_auc_posecnn(ad_v),
            }
            for th in (0.1,):
                sd[f'add(-s)_{th:.2f}'] = float((ad_v < th * diameter).sum() / n)
                sd[f'add-s_{th:.2f}'] = float((adi_v < th * diameter).sum() / n)
                sd[f'add_{th:.2f}'] = float((add_v < th * diameter).sum() / n)
            if all('mssd' in e for e in errs):
                # BOP'19 average recalls: MSSD over 0.05..0.5 of the
                # diameter, MSPD over 5..50 px scaled by image width / 640
                mssd_v = np.array([e['mssd'] for e in errs])
                mspd_v = np.array([e['mspd'] for e in errs])
                w = np.array([e.get('im_w', 640.0) for e in errs])
                sd['bop_mssd_ar'] = float(np.mean(
                    [(mssd_v < th * diameter).sum() / n
                     for th in np.arange(0.05, 0.51, 0.05)]))
                sd['bop_mspd_ar'] = float(np.mean(
                    [(mspd_v < r * w / 640.0).sum() / n
                     for r in np.arange(5, 51, 5)]))
            out[oid] = sd
        return out


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rotation by `angle` about the unit `axis` (Rodrigues), float64."""
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def _plain_table(rows: list[list[str]]) -> str:
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return '\n'.join('  '.join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                     for r in rows)


def gen_score_table(per_obj_score, obj_id_2_name=None, dataset_name=None,
                    num_digits=2):
    """Plain-text score tables (per row, per column), plain string formatting."""
    if obj_id_2_name is None:
        obj_id_2_name = DATASET_OBJ_NAMES.get(dataset_name)
    rows, header, by_type = [], None, defaultdict(list)
    for oid, sd in per_obj_score.items():
        if header is None:
            header = ['object'] + list(sd.keys())
            rows.append(header)
        name = obj_id_2_name[oid] if obj_id_2_name else str(oid)
        rows.append([name] + [f'{100 * v:.{num_digits}f}' for v in sd.values()])
        for k, v in sd.items():
            by_type[k].append(v)
    rows.append([f'Avg({len(per_obj_score)})'] +
                [f'{100 * np.mean(v):.{num_digits}f}' for v in by_type.values()])
    return _plain_table(rows), _plain_table([list(c) for c in zip(*rows)])


def csv_from_results(results: dict) -> dict:
    """BOP-format CSV text per solver."""
    csvs = {}
    for name, res in results.items():
        lines = []
        for e in res['errors']:
            if e['R_est'] is None:
                continue
            R = np.asarray(e['R_est']).reshape(-1)
            t = np.asarray(e['t_est']).reshape(-1)
            lines.append(','.join(map(str, (
                e['scene_id'], e['im_id'], e['obj_id'], e.get('score', 1),
                ' '.join(str(v) for v in R),
                ' '.join(str(v) for v in t), e.get('time', -1)))) + '\n')
        csvs[name] = ''.join(lines)
    return csvs
