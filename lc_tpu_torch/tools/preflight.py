"""Preflight check for a real-BOP run: verify every on-disk input a config
needs BEFORE spending a training/eval run discovering it is missing.

The reference's workflow (reference readme.md:39-70) assembles five kinds of
artifacts by hand — the BOP dataset tree, VOC backgrounds, image lists,
detector results, depth patches from tools/gen_z.py — and fails midway through
the first epoch (or at the first test batch) when one is absent. This tool
walks the exact paths the loaders will read (data/bop.py path
conventions, data/pipeline.py gating, eval/evaluator.py model dirs) and prints
one OK / MISSING line per requirement, with "required" determined by the
config itself (e.g. z_crop only when the pose loss is on; the detection JSON
only for the test split; the FPS pickle only for sparse_cnt > 0).

Usage (mirrors the train/test CLI; the port's copy of lc_tpu's
tools/preflight.py, which needs no jax):

    python -m lc_tpu_torch.tools.preflight --config configs/glmo.yaml --obj 1
    python -m lc_tpu_torch.tools.preflight --config configs/zlmo.yaml \
        --obj 1 --split test

Exit code 0 = every REQUIRED artifact present (optional ones may be missing);
1 = at least one required artifact missing. Host Python only: importing the
package loads torch, but no device is touched; runs in milliseconds on a
dataset of any size.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

from ..utils.config import load_config

MAX_SCENES_CHECKED = 50


class Report:
    def __init__(self):
        self.rows = []          # (status, required, what, detail)
        self.n_missing_required = 0

    def add(self, ok: bool, required: bool, what: str, detail: str = ''):
        self.rows.append((ok, required, what, detail))
        if required and not ok:
            self.n_missing_required += 1

    def print(self, out=sys.stdout):
        for ok, required, what, detail in self.rows:
            status = 'OK      ' if ok else (
                'MISSING ' if required else 'absent* ')
            line = f'{status} {what}'
            if detail:
                line += f'  ({detail})'
            print(line, file=out)
        print(file=out)
        n_ok = sum(1 for r in self.rows if r[0])
        print(f'{n_ok}/{len(self.rows)} present; '
              f'{self.n_missing_required} REQUIRED artifact(s) missing '
              f"(* = optional for this config)", file=out)


def _check_file(rep, path, what, required=True, detail=''):
    rep.add(osp.isfile(path), required, f'{what}: {path}', detail)
    return osp.isfile(path)


def _check_dir(rep, path, what, required=True, nonempty=False, detail=''):
    ok = osp.isdir(path) and (not nonempty or bool(os.listdir(path)))
    rep.add(ok, required, f'{what}: {path}', detail)
    return ok


def _scenes_from_lists(list_files):
    """Parse image-list lines ('split/scene/rgb/im.png', data/bop.py:45-80) into
    {(split, scene_id): first_frame_line}."""
    scenes = {}
    for fname in list_files:
        if not osp.isfile(fname):
            continue
        with open(fname) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.rsplit('/', 3)
                if len(parts) < 4:
                    continue
                key = (parts[-4], int(parts[-3]))
                scenes.setdefault(key, line)
    return scenes


def check_dataset(rep, cfg, ds_cfg, train: bool):
    tag = 'train' if train else 'test'
    root = ds_cfg.dataset_root
    if not _check_dir(rep, root, f'[{tag}] dataset_root'):
        return
    for lf in ds_cfg.list_files:
        _check_file(rep, lf, f'[{tag}] image list')
    scenes = _scenes_from_lists(ds_cfg.list_files)
    if not scenes:
        rep.add(False, True, f'[{tag}] image lists parse to ≥1 scene',
                'no split/scene/rgb/im lines found')
        return

    # training needs homo_z (built from gen_z.py z_crop patches) whenever any
    # loss consumes the dense XYZ target or the pose loss is on
    # (pipeline.py:182-242); evaluation never reads z_crop.
    loss = cfg.get('loss', {})
    need_z = train and (loss.get('w_loss_pose', 0) > 0
                        or loss.get('w_loss_noc', 0) > 0
                        or loss.get('w_loss_noc_bin', 0) > 0)
    checked = 0
    for (split, scene_id), frame in sorted(scenes.items()):
        if checked >= MAX_SCENES_CHECKED:
            rep.add(True, False,
                    f'[{tag}] …{len(scenes) - checked} more scene(s) skipped',
                    f'first {MAX_SCENES_CHECKED} checked')
            break
        checked += 1
        base = osp.join(root, split, f'{scene_id:06d}')
        for j in ('scene_gt.json', 'scene_gt_info.json', 'scene_camera.json'):
            _check_file(rep, osp.join(base, j), f'[{tag}] {split}/{scene_id}')
        _check_file(rep, osp.join(root, frame),
                    f'[{tag}] first rgb frame of {split}/{scene_id}')
        _check_dir(rep, osp.join(base, 'mask_visib'),
                   f'[{tag}] visible masks of {split}/{scene_id}',
                   nonempty=True)
        if need_z:
            _check_dir(rep, osp.join(root, split, 'z_crop', f'{scene_id:06d}'),
                       f'[{tag}] z_crop patches of {split}/{scene_id}',
                       nonempty=True,
                       detail='generate: python -m lc_tpu_torch.tools.gen_z '
                              f'--data_dir {root} --split {split}')

    if train and ds_cfg.get('switch_bg_prob', 0) > 0:
        bg = ds_cfg.get('bg_dir', '')
        if not bg:
            rep.add(False, True, f'[{tag}] bg_dir (switch_bg_prob='
                                 f'{ds_cfg.switch_bg_prob} needs backgrounds)')
        else:
            _check_dir(rep, bg, f'[{tag}] background images (switch_bg_prob='
                                f'{ds_cfg.switch_bg_prob})', nonempty=True)
    if not train and ds_cfg.get('detection'):
        _check_file(rep, ds_cfg.detection, f'[{tag}] detector results JSON')


def check_global(rep, cfg, obj_ids):
    ds = cfg.test_dataset if 'test_dataset' in cfg else cfg.train_dataset
    root = ds.dataset_root
    _check_file(rep, osp.join(root, 'models', 'models_info.json'),
                'models_info.json (NOC scales, symmetries)')
    eval_dir = ds.get('eval_model_dir') or osp.join(
        root, 'models_eval' if ds.get('use_eval_model', True) else 'models')
    if _check_dir(rep, eval_dir, 'evaluation model dir'):
        _check_file(rep, osp.join(eval_dir, 'models_info.json'),
                    'eval models_info.json (diameters)')
        for oid in obj_ids or []:
            _check_file(rep, osp.join(eval_dir, f'obj_{oid:06d}.ply'),
                        f'eval mesh obj {oid}')
    if cfg.get('sparse_cnt', 0) > 0:
        path = cfg.get('fps', '')
        ok = _check_file(rep, path, f'FPS keypoints (sparse_cnt='
                                    f'{cfg.sparse_cnt})')
        if ok and obj_ids:
            import pickle
            with open(path, 'rb') as f:
                fps = pickle.load(f)
            missing = [o for o in obj_ids if o not in fps]
            rep.add(not missing, True,
                    f'FPS entries for objs {list(obj_ids)}',
                    f'missing: {missing}' if missing else '')
    if cfg.get('transform_model', False):
        path = cfg.get('transform_path') or osp.join(root, 'models_xform.json')
        _check_file(rep, path, 'models_xform.json (transform_model: true)')


def preflight(cfg, obj_ids=None, split: str = 'both') -> Report:
    rep = Report()
    obj_ids = obj_ids or cfg.get('obj_ids')
    if split in ('both', 'train') and 'train_dataset' in cfg:
        check_dataset(rep, cfg, cfg.train_dataset, train=True)
        if 'train_dataset_1' in cfg:
            import copy
            d1 = copy.deepcopy(cfg.train_dataset_1)
            for k, v in cfg.train_dataset.items():
                if k not in d1:
                    d1[k] = v
            check_dataset(rep, cfg, d1, train=True)
    if split in ('both', 'test') and 'test_dataset' in cfg:
        check_dataset(rep, cfg, cfg.test_dataset, train=False)
    check_global(rep, cfg, obj_ids)
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--config', required=True)
    ap.add_argument('--obj', type=int, nargs='+')
    ap.add_argument('--split', choices=['both', 'train', 'test'],
                    default='both')
    ap.add_argument('--opts', nargs='+')
    args = ap.parse_args(argv)
    cfg = load_config(args.config, args.opts)
    rep = preflight(cfg, obj_ids=args.obj, split=args.split)
    rep.print()
    return 1 if rep.n_missing_required else 0


if __name__ == '__main__':
    sys.exit(main())
