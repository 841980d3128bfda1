"""Visualization helpers: pose axes, 3D bounding boxes, NOC/weight colormaps
(a copy of lc_tpu/utils/vis.py).

Host-side numpy/cv2 drawing (debug/figures only — never on the training path),
covering what the reference vendors in tools/lib/vis_utils/image.py (draw_bbox3d,
pose overlays) and colormap.py, rebuilt small: everything here takes plain numpy
arrays and the (R, t, K) pinhole convention used across lc_tpu and the port.
"""
from __future__ import annotations

import numpy as np

_BOX_EDGES = ((0, 1), (0, 2), (1, 3), (2, 3),
              (4, 5), (4, 6), (5, 7), (6, 7),
              (0, 4), (1, 5), (2, 6), (3, 7))


def project_points(pts3d: np.ndarray, R: np.ndarray, t: np.ndarray,
                   K: np.ndarray) -> np.ndarray:
    """(N, 3) model points -> (N, 2) pixels under K [R|t] (z clamped at 0.1)."""
    cam = pts3d @ R.T + t
    z = np.maximum(cam[:, 2:3], 0.1)
    uv = cam[:, :2] / z
    return uv * np.array([K[0, 0], K[1, 1]]) + np.array([K[0, 2], K[1, 2]])


def draw_bbox3d(img: np.ndarray, bbox_3d: np.ndarray, R: np.ndarray,
                t: np.ndarray, K: np.ndarray, color=(0, 255, 0),
                thickness: int = 1) -> np.ndarray:
    """Draw the 12 edges of an 8-corner 3D box (model_info.bbox3d_from_scale
    corner order: binary-counting over (x, y, z)). Returns a copy."""
    import cv2
    out = np.ascontiguousarray(img.copy())
    uv = project_points(np.asarray(bbox_3d, np.float64), R, t, K)
    for a, b in _BOX_EDGES:
        cv2.line(out, tuple(np.round(uv[a]).astype(int)),
                 tuple(np.round(uv[b]).astype(int)), color, thickness,
                 cv2.LINE_AA)
    return out


def draw_pose_axes(img: np.ndarray, R: np.ndarray, t: np.ndarray,
                   K: np.ndarray, length: float = 50.0,
                   thickness: int = 2) -> np.ndarray:
    """Draw the object frame: X red, Y green, Z blue (mm units). Returns a copy."""
    import cv2
    out = np.ascontiguousarray(img.copy())
    pts = np.array([[0, 0, 0], [length, 0, 0], [0, length, 0], [0, 0, length]],
                   np.float64)
    uv = np.round(project_points(pts, R, t, K)).astype(int)
    for i, color in enumerate(((255, 0, 0), (0, 255, 0), (0, 0, 255))):
        cv2.line(out, tuple(uv[0]), tuple(uv[i + 1]), color, thickness,
                 cv2.LINE_AA)
    return out


def noc_to_rgb(noc: np.ndarray, mask: np.ndarray | None = None) -> np.ndarray:
    """NOC field (H, W, 3) in [-1, 1] -> uint8 RGB (the standard coordinate-as-
    color rendering); pixels outside `mask` are black."""
    rgb = np.clip((np.asarray(noc) * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    if mask is not None:
        rgb = np.where(np.asarray(mask)[..., None] > 0, rgb, 0)
    return rgb


def weight_heatmap(w: np.ndarray) -> np.ndarray:
    """Scalar field (H, W) -> uint8 RGB jet-style heatmap, self-normalized."""
    import cv2
    w = np.asarray(w, np.float32)
    lo, hi = float(w.min()), float(w.max())
    norm = (w - lo) / max(hi - lo, 1e-12)
    return cv2.applyColorMap((norm * 255).astype(np.uint8),
                             cv2.COLORMAP_JET)[..., ::-1]


def overlay_mask(img: np.ndarray, mask: np.ndarray, color=(0, 255, 0),
                 alpha: float = 0.45) -> np.ndarray:
    """Alpha-blend a binary mask onto an image. Returns uint8 copy."""
    out = np.asarray(img, np.float32).copy()
    m = (np.asarray(mask) > 0)[..., None]
    out = np.where(m, out * (1 - alpha) + np.asarray(color, np.float32) * alpha,
                   out)
    return np.clip(out, 0, 255).astype(np.uint8)
