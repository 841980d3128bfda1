"""Network output decoding and on-the-fly training targets (counterpart of
lc_tpu/loss/targets.py): the continuous NOC head and the binary Gray-code
head, decoded at inference or, in training, straight through with the GT
bits.

Symmetry candidates come padded to a fixed K with a validity mask
(geom.symmetry.pad_candidates), so the selection is one batched argmin.
Everything is channel-last.
"""
from __future__ import annotations

import torch

from ..codec import logits_to_noc, logits_to_noc_with_gt, noc_to_nn_target
from ..geom.pose import RT_to_pose7
from ..geom.projection import xyz_from_homo_z
from ..geom.symmetry import select_pose_2d, select_pose_3d


def nn_out_to_xyz(nn_out: torch.Tensor, noc_scale_xfd: torch.Tensor, *,
                  raw_bits_gt: torch.Tensor | None = None,
                  noc_mask: torch.Tensor | None = None,
                  model_transform: torch.Tensor | None = None,
                  bit_cnt=None, black_background: bool = False,
                  inference: bool = False) -> torch.Tensor:
    """Decode network output channels into model-frame XYZ.

    nn_out: (B, ..., C) channel-last, C = 3 for the continuous NOC head,
    sum(bit_cnt) Gray-code logits for the binary one; noc_scale_xfd: (B, 3);
    model_transform: (B, 4, 4), the model -> canonical-frame transform
    x_xfd = R x + t, or None. The binary head decodes at inference with the
    soft LSB, in training (inference=False) with the GT's plain bits
    raw_bits_gt (B, ..., C) and mask noc_mask (B, ...). Returns (B, ..., 3).
    """
    def bshape(x):          # (B, 3) -> (B, 1, ..., 1, 3)
        return x.reshape(x.shape[:1] + (1,) * (nn_out.dim() - 2)
                         + x.shape[1:])

    if bit_cnt is None:
        if model_transform is not None:
            raise ValueError('model transform not supported for continuous '
                             'xyz output (matches reference)')
        return nn_out * bshape(noc_scale_xfd)
    if inference:
        noc = logits_to_noc(nn_out, bit_cnt, black_background)
    else:
        noc = logits_to_noc_with_gt(nn_out, raw_bits_gt, bit_cnt, noc_mask,
                                    black_background)
    xyz_xfd = noc * bshape(noc_scale_xfd)
    if model_transform is None:
        return xyz_xfd
    # x = Rᵀ (x_xfd − t), as rows: (x_xfd − t) @ R
    R = model_transform[:, :3, :3]
    R = R.reshape(R.shape[:1] + (1,) * (nn_out.dim() - 3) + (3, 3))
    return (xyz_xfd - bshape(model_transform[:, :3, 3])) @ R


def xyz_to_nn_target(xyz: torch.Tensor, noc_scale_xfd: torch.Tensor, *,
                     noc_mask=None, model_transform=None, bit_cnt=None,
                     black_background: bool = False):
    """GT XYZ (B, H, W, 3) -> (target, raw_bits), channel-last: the NOC
    target and None for the continuous head; with bit_cnt the Gray-code
    target (float32) and the plain binary bits (bool) of the NOC in the
    canonical frame of model_transform (zero outside noc_mask)."""
    xyz = xyz.detach()
    if model_transform is not None:
        R = model_transform[:, None, :3, :3]                  # (B, 1, 3, 3)
        t = model_transform[:, None, None, :3, 3]             # (B, 1, 1, 3)
        xyz = xyz @ R.transpose(-1, -2) + t
        if noc_mask is not None:
            xyz = xyz * noc_mask[..., None]
    noc = xyz / noc_scale_xfd[:, None, None, :]
    if bit_cnt is None:
        if model_transform is not None:
            raise ValueError('model transform not supported for continuous '
                             'xyz output (matches reference)')
        return noc, None
    return noc_to_nn_target(noc, bit_cnt, black_background)


def select_best_pose(gt: dict, out: dict, *, sym_aware_started: bool,
                     bit_cnt=None, black_background: bool = False):
    """The best symmetry candidate per sample and the GT XYZ map.

    gt: Rt_candi (B, K, 3, 4), candi_valid (B, K), homo_z_out (B, h, w, 3),
    K_no_aug, msk_noc (B, h, w), sym_ck_pts2d (B, S, 2), noc_scale (B, 3),
    out_K; model_transform (B, 4, 4) and pts3d where the config has them.
    Returns (Rt_best (B, 3, 4), pose_best (B, 7), xyz_gt (B, h, w, 3))."""
    candis = gt['Rt_candi']
    candi_valid = gt.get('candi_valid')
    B, K = candis.shape[:2]
    homo_z = gt['homo_z_out']
    h, w = homo_z.shape[1:3]
    K_no_aug = gt['K_no_aug']
    if K == 1 or not sym_aware_started:
        Rt_best = candis[:, 0]
    elif 'pts2d' in out:         # sparse: 2D reprojection of the keypoints
        Rt_best = select_pose_2d(gt['out_K'], gt['pts3d'], out['pts2d'],
                                 candis, candi_valid)
    else:                        # dense: 3D error at the check points
        pts2d = torch.clamp(gt['sym_ck_pts2d'], min=0).long()
        xg, yg = pts2d[..., 0], pts2d[..., 1]
        bidx = torch.arange(B, device=pts2d.device)[:, None]
        nn_out = out['xyz_noc'] if 'xyz_noc' in out else out['xyz_noc_bin']
        ck_pts3d = nn_out_to_xyz(
            nn_out[bidx, yg, xg], gt['noc_scale'], bit_cnt=bit_cnt,
            model_transform=gt.get('model_transform'),
            black_background=black_background, inference=True)
        Rt_best = select_pose_3d(K_no_aug, ck_pts3d, homo_z[bidx, yg, xg],
                                 candis, candi_valid)
    pose_best = RT_to_pose7(Rt_best[..., :3], Rt_best[..., 3])
    xyz = xyz_from_homo_z(homo_z.reshape(B, h * w, 3), Rt_best[..., :3],
                          Rt_best[..., 3], K_no_aug)
    xyz_gt = xyz.reshape(B, h, w, 3) * gt['msk_noc'][..., None]
    return Rt_best, pose_best, xyz_gt


@torch.no_grad()
def annots_on_the_fly(gt: dict, out: dict, *, step: int,
                      sym_aware_start: int = 0, bit_cnt=None,
                      black_background: bool = False) -> dict:
    """Training targets for the current predictions, outside the graph:
    Rt_best, pose_best, xyz_gt and either xyz_noc_tgt (continuous head) or
    xyz_noc_bin_tgt and xyz_noc_bin_raw (Gray codes)."""
    out = {k: v.detach() for k, v in out.items()}
    sym_started = gt['Rt_candi'].shape[1] > 1 and step >= sym_aware_start
    Rt_best, pose_best, xyz_gt = select_best_pose(
        gt, out, sym_aware_started=sym_started, bit_cnt=bit_cnt,
        black_background=black_background)
    target, raw_bits = xyz_to_nn_target(
        xyz_gt, gt['noc_scale'], noc_mask=gt['msk_noc'],
        model_transform=gt.get('model_transform'), bit_cnt=bit_cnt,
        black_background=black_background)
    annot = dict(Rt_best=Rt_best, pose_best=pose_best, xyz_gt=xyz_gt)
    if raw_bits is None:
        annot['xyz_noc_tgt'] = target
    else:
        annot['xyz_noc_bin_tgt'] = target
        annot['xyz_noc_bin_raw'] = raw_bits
    return annot
