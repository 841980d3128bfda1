"""lc_tpu_torch.geom against lc_tpu.geom on the same numpy inputs.

Tolerance: atol 1e-5 (f32 elementwise arithmetic in both frameworks; values
are O(1) for rotations, O(1e2-1e3) pixels/mm scaled accordingly)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as sciR

from lc_tpu import geom as jgeom
from lc_tpu.geom import affine as jaffine
from lc_tpu.geom import rotations as jrot
from lc_tpu_torch import geom as tgeom
from lc_tpu_torch.geom import affine as taffine
from lc_tpu_torch.geom import rotations as trot

RNG = np.random.default_rng(0)


def _close(t, j, atol=1e-5, rtol=1e-6):
    np.testing.assert_allclose(t.numpy() if torch.is_tensor(t) else t,
                               np.asarray(j), atol=atol, rtol=rtol)


def _quats(n=64):
    q = RNG.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize('name', ['quaternion_to_matrix', 'standardize_quaternion'])
def test_quaternion_fns(name):
    q = _quats()
    _close(getattr(trot, name)(torch.from_numpy(q)),
           getattr(jrot, name)(jnp.asarray(q)))


def test_matrix_to_quaternion_all_branches():
    # rotations near 0, π about each axis and random: every Shepperd branch
    Rs = np.concatenate([
        sciR.random(64, random_state=1).as_matrix(),
        sciR.from_rotvec(np.eye(3) * (np.pi - 1e-3)).as_matrix(),
        sciR.from_rotvec(np.eye(3) * 1e-4).as_matrix()]).astype(np.float32)
    _close(trot.matrix_to_quaternion(torch.from_numpy(Rs)),
           jrot.matrix_to_quaternion(jnp.asarray(Rs)))


@pytest.mark.parametrize('scale', [1e-6, 1e-3, 1.0, 3.0])
def test_axis_angle(scale):
    aa = (RNG.normal(size=(32, 3)) * scale).astype(np.float32)
    for name in ('axis_angle_to_quaternion', 'axis_angle_to_quaternion_near_zero',
                 'axis_angle_to_matrix'):
        _close(getattr(trot, name)(torch.from_numpy(aa)),
               getattr(jrot, name)(jnp.asarray(aa)))


def test_skew_and_multiply():
    v = RNG.normal(size=(16, 3)).astype(np.float32)
    _close(trot.skew_symmetric(torch.from_numpy(v)),
           jrot.skew_symmetric(jnp.asarray(v)))
    a, b = _quats(16), _quats(16)
    _close(trot.quaternion_raw_multiply(torch.from_numpy(a), torch.from_numpy(b)),
           jrot.quaternion_raw_multiply(jnp.asarray(a), jnp.asarray(b)))


def test_pose_roundtrip_and_perturb():
    R = sciR.random(16, random_state=2).as_matrix().astype(np.float32)
    t = RNG.uniform(-100, 800, (16, 3)).astype(np.float32)
    p_t = tgeom.RT_to_pose7(torch.from_numpy(R), torch.from_numpy(t))
    p_j = jgeom.RT_to_pose7(jnp.asarray(R), jnp.asarray(t))
    _close(p_t, p_j, atol=1e-4)
    R2, t2 = tgeom.pose7_to_RT(p_t)
    _close(R2, R, atol=1e-5)
    d = (RNG.normal(size=(16, 6)) * [0.05, 0.05, 0.05, 5, 5, 5]).astype(np.float32)
    _close(tgeom.apply_perturb(p_t, torch.from_numpy(d)),
           jgeom.apply_perturb(jnp.asarray(p_t.numpy()), jnp.asarray(d)),
           atol=1e-4)


def test_projection_with_z_clamp():
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
    R = sciR.random(4, random_state=3).as_matrix().astype(np.float32)
    t = np.array([[0, 0, 600], [10, -5, 700], [0, 0, 0.05], [0, 0, -50]],
                 np.float32)            # last two rows exercise the z clamp
    pts = RNG.uniform(-40, 40, (4, 50, 3)).astype(np.float32)
    Ks = np.broadcast_to(K, (4, 3, 3)).copy()
    tp = tgeom.project_apply(*map(torch.from_numpy, (Ks, pts, R, t)))
    jp = jgeom.project_apply(*map(jnp.asarray, (Ks, pts, R, t)))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-2)
    _close(tgeom.gen_uv((5, 7)), jgeom.gen_uv((5, 7)), atol=0)


def test_affine():
    center = RNG.uniform(100, 500, (8, 2)).astype(np.float32)
    scale = RNG.uniform(50, 300, (8,)).astype(np.float32)
    rot = RNG.uniform(-np.pi, np.pi, (8,)).astype(np.float32)
    shift = RNG.uniform(-0.2, 0.2, (8, 2)).astype(np.float32)
    a_t = taffine.crop_affine(center, scale, rot, (256, 256), shift)
    a_j = jaffine.crop_affine(center, scale, rot, (256, 256), shift)
    np.testing.assert_array_equal(a_t, a_j)       # same numpy arithmetic
    np.testing.assert_array_equal(taffine.invert_affine(a_t),
                                  jaffine.invert_affine(a_j))
    np.testing.assert_allclose(
        taffine.invert_affine(torch.from_numpy(a_t), xp=torch).numpy(),
        jaffine.invert_affine(a_j), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(taffine.affine33(a_t), jaffine.affine33(a_j))
