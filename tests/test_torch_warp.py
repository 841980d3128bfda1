"""The port's rotated-crop warp (lc_tpu_torch/ops/warp.py) against lc_tpu's
(lc_tpu/ops/pallas_warp.py) on numpy-made inputs.

Tolerances: the shear's plain version against shear_x_reference and against
the Pallas kernel in interpret mode, atol 5e-4 on 0-255 values (that of
tests/test_pallas_warp.py; both compute the same f32 lerp). The composed
warp against lc_tpu's, atol 1e-2 on 0-255 values: the 1.5x crop is two f32
matmuls whose sums run in another order in each framework. Against cv2,
the bound of tests/test_pallas_warp.py (interior p95 < 12, mean < 4)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lc_tpu.ops import pallas_warp as pw
from lc_tpu_torch.ops import warp as tw

RNG = np.random.default_rng(21)
ROTS = [0.0, 0.3, -0.6, 1.2, 2.5, 3.5, 5.0]


def smooth_image(B, H, W, C=3, seed=0):
    """Low-frequency image: resampling differences stay small."""
    small = np.random.default_rng(seed).uniform(
        0, 255, (B, H // 8, W // 8, C)).astype(np.float32)
    return np.asarray(jax.image.resize(jnp.asarray(small), (B, H, W, C),
                                       'bilinear'))


@pytest.mark.parametrize('C', [3, 1])
def test_shear_plain_matches_lc_tpu(C):
    img = RNG.uniform(0, 255, (2, 8, 16, C)).astype(np.float32)
    shifts = RNG.uniform(-3, 3, (2, 8)).astype(np.float32)
    shifts[1, 3] = 2.0                      # an integer shift: f = 0
    ref = np.asarray(pw.shear_x_reference(jnp.asarray(img),
                                          jnp.asarray(shifts)))
    pal = np.asarray(pw.shear_x_pallas(jnp.asarray(img), jnp.asarray(shifts),
                                       interpret=True))
    got = tw.shear_x_auto(torch.from_numpy(img), torch.from_numpy(shifts))
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4)
    np.testing.assert_allclose(got.numpy(), pal, atol=5e-4)


def test_shear_axis1_is_the_swapped_shear():
    """axis=1 shifts along y with one shift per column: lc_tpu's
    swapaxes -> shear -> swapaxes; shifts beyond the line read zero."""
    img = RNG.uniform(0, 255, (2, 8, 12, 3)).astype(np.float32)
    shifts = RNG.uniform(-5, 5, (2, 12)).astype(np.float32)
    shifts[0, 0], shifts[1, 5] = 40.0, -100.0
    ref = np.swapaxes(np.asarray(pw.shear_x_reference(
        jnp.asarray(np.swapaxes(img, 1, 2)), jnp.asarray(shifts))), 1, 2)
    got = tw.shear_x_reference(torch.from_numpy(img), torch.from_numpy(shifts),
                               axis=1)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4)
    assert np.all(got.numpy()[0, :, 0] == 0) and np.all(got.numpy()[1, :, 5] == 0)


@pytest.mark.parametrize('n', [6, 7])
def test_quadrant_fold_matches_lc_tpu(n):
    """The fold by indexing equals lc_tpu's flip/roll/swapaxes stack, the
    roll by one included, for every quarter turn."""
    img = RNG.uniform(0, 1, (4, n, n, 2)).astype(np.float32)
    q = np.array([0, 1, 2, 3])
    ref = np.asarray(pw._apply_quadrant(jnp.asarray(img), jnp.asarray(q)))
    got = tw.apply_quadrant(torch.from_numpy(img), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_rotated_crop_matches_lc_tpu_and_cv2():
    """All rotations of tests/test_pallas_warp.py in one batch of 14."""
    import cv2
    from lc_tpu_torch.geom.affine import crop_affine
    B, H, W = 2, 240, 320
    img = np.repeat(smooth_image(B, H, W), len(ROTS), 0)
    center = np.tile(np.array([[160.0, 120.0], [150.0, 130.0]], np.float32),
                     (len(ROTS), 1))
    scale = np.tile(np.array([140.0, 120.0], np.float32), len(ROTS))
    rot = np.repeat(np.asarray(ROTS, np.float32), B)
    out_wh = (64, 64)
    ref = np.asarray(pw.rotated_crop_warp(
        jnp.asarray(img), jnp.asarray(center), jnp.asarray(scale),
        jnp.asarray(rot), out_wh, use_pallas=False))
    got = tw.rotated_crop_warp(torch.from_numpy(img), torch.from_numpy(center),
                               torch.from_numpy(scale), torch.from_numpy(rot),
                               out_wh).numpy()
    assert got.shape == ref.shape == (len(rot), 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=1e-2)
    inter = (slice(8, -8), slice(8, -8))
    for b in range(len(rot)):
        aff = crop_affine(center[b], scale[b], rot[b], out_wh)
        cv = cv2.warpAffine(img[b], aff.astype(np.float32), out_wh,
                            flags=cv2.INTER_LINEAR)
        err = np.abs(got[b][inter] - cv[inter])
        assert np.quantile(err, 0.95) < 12.0, (rot[b], err.max())
        assert err.mean() < 4.0, (rot[b], err.mean())


def test_cuda_wrapper_rejects_cpu_tensors():
    """On the CPU the wrapper raises; only shear_x_auto takes the plain
    version, and only because the tensor lies on the CPU."""
    img = torch.zeros(1, 4, 4, 1)
    with pytest.raises(ValueError, match='CUDA'):
        tw.shear_x_cuda(img, torch.zeros(1, 4))
    with pytest.raises(TypeError):
        tw.shear_x_cuda(img.double(), torch.zeros(1, 4))
    with pytest.raises(ValueError, match='shape'):
        tw.shear_x_cuda(img, torch.zeros(1, 5))
    with pytest.raises(ValueError, match='1 or 3 channels'):
        tw.shear_x_cuda(torch.zeros(1, 4, 4, 2), torch.zeros(1, 4))
