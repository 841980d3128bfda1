"""Card-only tests of the port's CUDA kernels against their plain versions.
They import no jax, so they also run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA device every test here skips. LM tolerance (that of
tests/test_pallas_lm.py): translation atol 0.05 mm, |q·q'| > 1 − 1e-5, cost
rtol 1e-3, identical invalid flags; the others' at their sections."""
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as sciR

from lc_tpu_torch.geom.pose import RT_to_pose7, apply_perturb
from lc_tpu_torch.geom.projection import project_apply
from lc_tpu_torch.pnp.solver import lm_refine, lm_refine_auto

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def make_problem(B, N, seed, device, per_coord=True, valid_frac=0.7):
    rng = np.random.default_rng(seed)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    R = f32(sciR.random(B, random_state=seed).as_matrix())
    t = f32(np.concatenate((rng.uniform(-50, 50, (B, 2)),
                            rng.uniform(600, 800, (B, 1))), -1))
    pts3d = f32(rng.uniform(-40, 40, (B, N, 3)))
    Ks = f32(np.broadcast_to(K, (B, 3, 3)))
    uv = project_apply(Ks, pts3d, R, t) + f32(rng.normal(size=(B, N, 2)) * 0.3)
    start = apply_perturb(RT_to_pose7(R, t), f32(
        rng.normal(size=(B, 6)) * np.array([0.04, 0.04, 0.04, 8, 8, 15])))
    w = f32(rng.uniform(0.5, 2.0, (B, N, 2) if per_coord else (B, N)))
    valid = torch.tensor(rng.random((B, N)) < valid_frac)
    return [x.to(device).contiguous() for x in (start, Ks, pts3d, uv, w, valid)]


def _agree(out, ref):
    assert (out.pose7[:, 4:] - ref.pose7[:, 4:]).abs().max() <= 0.05
    assert (out.pose7[:, :4] * ref.pose7[:, :4]).sum(-1).abs().min() >= 1 - 1e-5
    rel = (out.cost - ref.cost).abs() / ref.cost.abs().clamp(min=1e-12)
    assert rel.max() <= 1e-3
    assert torch.equal(out.invalid, ref.invalid)


@pytest.mark.parametrize('case', ['final_refine', 'polish', 'edges_N1000',
                                  'weights_BN_no_valid_N1001',
                                  'ran_out_fallback', 'ran_out_keep'])
def test_kernel_matches_plain(cuda, case):
    """N = 1000 leaves the valid rows, N = 1001 every row, off 16-byte
    boundaries (the kernel's plain-load branch)."""
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    N = {'edges_N1000': 1000, 'weights_BN_no_valid_N1001': 1001}.get(case, 1024)
    args = make_problem(32, N, seed=3, device=cuda,
                        per_coord=case not in ('polish',
                                               'weights_BN_no_valid_N1001'))
    kw = {'polish': dict(max_iter=10, fallback_to_init=False),
          'ran_out_fallback': dict(max_iter=2, fallback_to_init=True),
          'ran_out_keep': dict(max_iter=2, fallback_to_init=False)}.get(
              case, dict(max_iter=50, fallback_to_init=True))
    if case == 'polish':
        args[4] = torch.ones_like(args[4])
    if case == 'edges_N1000':
        args[5][0, 2:] = False
    if case == 'weights_BN_no_valid_N1001':
        args[5] = None
    before = lm_refine_cuda.launches
    out = lm_refine_auto(*args, **kw)
    torch.cuda.synchronize()
    assert lm_refine_cuda.launches == before + 1
    _agree(out, lm_refine(*args, **kw))
    if case == 'edges_N1000':
        assert bool(out.invalid[0]) and torch.equal(out.pose7[0], args[0][0])
    if case.startswith('ran_out'):
        ran_out = out.invalid & (out.n_iter == 2)
        assert ran_out.any()
        kept = (out.pose7[ran_out] == args[0][ran_out]).all(-1)
        assert bool(kept.all()) if case == 'ran_out_fallback' \
            else not bool(kept.all())


def test_kernel_at_max_points(cuda):
    """The largest N the wrapper takes, per-coordinate weights and a mask
    (the widest rows), a quarter of it in each block of a problem's
    cluster; one more point raises."""
    from lc_tpu_torch.pnp import lm_kernel
    N = lm_kernel.max_points(torch.cuda.current_device())
    args = make_problem(4, N, seed=5, device=cuda)
    out = lm_kernel.lm_refine_cuda(*args)
    torch.cuda.synchronize()
    _agree(out, lm_refine(*args))
    big = make_problem(1, N + 1, seed=6, device=cuda)
    with pytest.raises(ValueError, match='exceed'):
        lm_kernel.lm_refine_cuda(*big)


def test_kernel_call_is_one_device_operation(cuda, monkeypatch):
    """A call through lm_refine_auto checks its inputs once and runs one
    device operation (kernels, copies, memsets, from the profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from lc_tpu_torch.pnp import lm_kernel
    calls = []
    real = lm_kernel.check_inputs
    monkeypatch.setattr(lm_kernel, 'check_inputs',
                        lambda *a: calls.append(1) or real(*a))
    args = make_problem(32, 1024, seed=7, device=cuda)
    lm_refine_auto(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            lm_refine_auto(*args)
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    assert ops == 4, [(e.key, e.count) for e in prof.key_averages()]
    assert len(calls) == 5


def test_kernel_rejects_cpu_and_bad_dtype(cuda):
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    args = make_problem(2, 16, seed=4, device=cuda)
    with pytest.raises(ValueError):
        lm_refine_cuda(*[a.cpu() for a in args])
    args[2] = args[2].double()
    with pytest.raises(TypeError):
        lm_refine_cuda(*args)


# ---------------------------------------------------------------------------
# B2: the shear kernel (csrc/shear_x.cu) against its plain version, atol 5e-4
# on 0-255 values (that of tests/test_pallas_warp.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('C,axis', [(3, 0), (1, 0), (3, 1)])
def test_shear_kernel_matches_plain(cuda, C, axis):
    from lc_tpu_torch.ops.warp import shear_x_auto, shear_x_cuda, shear_x_reference
    g = torch.Generator(device=cuda).manual_seed(C + axis)
    img = torch.rand(4, 96, 128, C, generator=g, device=cuda) * 255
    n = img.shape[2 - axis]                 # the length of a sheared line
    lines = img.shape[1 + axis]             # one shift per line
    line = torch.arange(lines, device=cuda) - lines / 2
    slope = torch.rand(4, 1, generator=g, device=cuda) * 2 - 1
    shifts = (slope * line[None]).contiguous()
    shifts[0, :3] = torch.tensor([n + 5.0, -n - 5.0, 1e6], device=cuda)
    before = shear_x_cuda.launches
    out = shear_x_auto(img, shifts, axis)
    torch.cuda.synchronize()
    assert shear_x_cuda.launches == before + 1
    ref = shear_x_reference(img, shifts, axis)
    assert (out - ref).abs().max().item() <= 5e-4
    assert torch.all((out[0, :3] if axis == 0 else out[0, :, :3]) == 0)


@pytest.mark.parametrize('n', [384, 383, 97])
@pytest.mark.parametrize('C', [1, 3])
def test_shear_columns_nonlinear_shifts(cuda, C, n):
    """The column pass with a random shift per column, uniform in ±n/2 (the
    window exceeds a tile's shared memory and is walked in chunks), and
    sizes that are not multiples of the 32 x 64 tile."""
    from lc_tpu_torch.ops.warp import shear_x_cuda, shear_x_reference
    g = torch.Generator(device=cuda).manual_seed(n + C)
    img = torch.rand(3, n, n + 5, C, generator=g, device=cuda) * 255
    shifts = (torch.rand(3, n + 5, generator=g, device=cuda) - 0.5) * n
    out = shear_x_cuda(img, shifts, 1)
    torch.cuda.synchronize()
    assert (out - shear_x_reference(img, shifts, 1)).abs().max().item() <= 5e-4


def test_shear_kernel_rejects_cpu_and_bad_dtype(cuda):
    from lc_tpu_torch.ops.warp import shear_x_cuda
    img = torch.zeros(2, 8, 8, 3, device=cuda)
    shifts = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError, match='CUDA'):
        shear_x_cuda(img.cpu(), shifts.cpu())
    with pytest.raises(TypeError):
        shear_x_cuda(img.double(), shifts)
    with pytest.raises(ValueError, match='contiguous'):
        shear_x_cuda(img.transpose(1, 2), shifts)


def test_rotated_crop_warp_kernel_matches_plain(cuda):
    """The composed warp on the card (three kernel launches) against the
    same composition with the plain shear, atol 5e-4 on 0-255 values."""
    from lc_tpu_torch.ops import warp
    g = torch.Generator(device=cuda).manual_seed(0)
    img = torch.rand(4, 240, 320, 3, generator=g, device=cuda) * 255
    center = torch.tensor([[160.0, 120.0], [150.0, 130.0]] * 2, device=cuda)
    scale = torch.tensor([140.0, 120.0, 100.0, 90.0], device=cuda)
    rot = torch.tensor([0.3, 1.9, 3.5, 5.9], device=cuda)
    before = warp.shear_x_cuda.launches
    out = warp.rotated_crop_warp(img, center, scale, rot, (64, 64))
    torch.cuda.synchronize()
    assert warp.shear_x_cuda.launches == before + 3
    plain = warp.rotated_crop_warp(img, center, scale, rot, (64, 64),
                                   shear=warp.shear_x_reference)
    assert (out - plain).abs().max().item() <= 5e-4


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_global_batch_norm_cuda_matches_plain(cuda, dtype, tmp_path):
    """The data-parallel BatchNorm's CUDA branch (torch's fused batch-norm
    kernels) against its plain branch, the same values on the CPU, in a
    one-rank gloo group: the output, the running statistics and the three
    gradients within 1e-5 (f32) / 1e-12 (f64)."""
    import torch.distributed as dist
    from lc_tpu_torch.models.layers import _GlobalBatchNorm
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, 6, 5, generator=g, dtype=dtype) * 3 + 1
    w = torch.rand(8, generator=g, dtype=dtype) + 0.5
    b = torch.randn(8, generator=g, dtype=dtype)
    cot = torch.randn(x.shape, generator=g, dtype=dtype)
    dist.init_process_group('gloo', store=dist.FileStore(
        str(tmp_path / 'store'), 1), rank=0, world_size=1)
    res = []
    try:
        for dev in ('cpu', cuda):
            xs, ws, bs = (t.to(dev, copy=True).requires_grad_()
                          for t in (x, w, b))
            rm = torch.zeros(8, dtype=dtype, device=dev)
            rv = torch.ones(8, dtype=dtype, device=dev)
            y = _GlobalBatchNorm.apply(xs, ws, bs, rm, rv, 0.1, 1e-5,
                                       dist.group.WORLD, 0, 1)
            y.backward(cot.to(dev))
            res.append([t.detach().cpu() for t in (y, rm, rv, xs.grad,
                                                   ws.grad, bs.grad)])
    finally:
        dist.destroy_process_group()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for name, plain, fused in zip(('y', 'running_mean', 'running_var', 'dx',
                                   'dweight', 'dbias'), *res):
        torch.testing.assert_close(fused, plain, rtol=tol, atol=tol,
                                   msg=name)


# ---------------------------------------------------------------------------
# minimal6: RANSAC's hypothesis kernel (csrc/minimal6.cu) against its plain
# version, fast_minimal.minimal6, on the card; the tolerances of
# tests/test_torch_fast_minimal.py
# ---------------------------------------------------------------------------

def minimal_samples(B, Kh, noise, planar, seed, device):
    """6-point samples as tests/test_pnp.py:301-372 makes them: spread in a
    100 mm cube, or on a random plane, 400-600 mm in front of the camera,
    with `noise` px of Gaussian noise. (cam_K, sub3d, sub2d) on device."""
    rng = np.random.default_rng(seed)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
    Kc = np.broadcast_to(K, (B, 3, 3)).copy()
    Rs = sciR.random(B * Kh, random_state=seed + 1).as_matrix().reshape(
        B, Kh, 3, 3)
    ts = np.concatenate((rng.uniform(-5, 5, (B, Kh, 2)),
                         rng.uniform(400, 600, (B, Kh, 1))), -1)
    if planar:
        frames = sciR.random(B * Kh, random_state=seed + 2).as_matrix(
        ).reshape(B, Kh, 3, 3)
        ab = rng.uniform(-50, 50, (B, Kh, 6, 2))
        P3 = (ab[..., :1] * frames[:, :, None, :, 0]
              + ab[..., 1:2] * frames[:, :, None, :, 1])
    else:
        P3 = rng.uniform(-50, 50, (B, Kh, 6, 3))
    P3 = P3.astype(np.float32)
    cam = np.einsum('bkij,bknj->bkni', Rs, P3) + ts[:, :, None]
    uvw = np.einsum('bij,bknj->bkni', Kc, cam)
    uv = uvw[..., :2] / uvw[..., 2:3] + rng.normal(0, noise, uvw[..., :2].shape)
    return [torch.tensor(np.asarray(a, np.float32), device=device)
            for a in (Kc, P3, uv)]


def hold_minimal6(name, noise, p, ok, pr, okr):
    """The kernel (p, ok) against the plain version (pr, okr), one
    estimator's (B, K) block."""
    p, ok, pr, okr = (t.cpu().numpy() for t in (p, ok, pr, okr))
    both = ok & okr
    dt = np.abs(p[..., 4:] - pr[..., 4:]).max(-1)[both]
    dq = np.abs(np.sum(p[..., :4] * pr[..., :4], -1))[both]
    assert (ok == okr).mean() >= 0.99, (ok == okr).mean()
    if name == 'dlt':
        assert np.median(dt) < 0.1 and np.quantile(dt, 0.9) < 1.0
        assert np.quantile(dq, 0.1) > 1 - 1e-4
    elif noise == 0:
        assert np.quantile(dt, 0.99) < 0.05 and np.quantile(dq, 0.01) > 1 - 1e-5
    else:
        dtn = np.linalg.norm(p[..., 4:] - pr[..., 4:], axis=-1)[both]
        assert np.median(dtn) < 0.1 and np.percentile(dtn, 90) < 5.0


@pytest.mark.parametrize('noise,planar', [(0.0, False), (1.0, False),
                                          (0.0, True)])
def test_minimal6_kernel_matches_plain(cuda, noise, planar):
    from lc_tpu_torch.pnp import fast_minimal
    from lc_tpu_torch.pnp.minimal6_kernel import minimal6_cuda
    args = minimal_samples(32, 150, noise, planar, seed=0, device=cuda)
    before = minimal6_cuda.launches
    pose, ok = minimal6_cuda(*args)
    torch.cuda.synchronize()
    assert minimal6_cuda.launches == before + 1
    pr, okr = fast_minimal.minimal6(*args)
    Kh = args[1].shape[1]
    for e, name in enumerate(fast_minimal.ESTIMATORS):
        if planar != (name == 'planar'):
            continue   # each estimator on the samples it is made for
        sl = slice(e * Kh, (e + 1) * Kh)
        hold_minimal6(name, noise, pose[:, sl], ok[:, sl], pr[:, sl],
                      okr[:, sl])
    assert torch.isfinite(pose).all()


def test_minimal6_estimator_subset_and_ransac_dispatch(cuda):
    """A subset of estimators keeps lc_tpu's order; ransac_pnp on the card
    launches the kernel once a call and never the generic estimators."""
    from lc_tpu_torch.pnp import fast_minimal, ransac
    from lc_tpu_torch.pnp.minimal6_kernel import minimal6_cuda
    args = minimal_samples(4, 20, 1.0, False, seed=3, device=cuda)
    full, _ = minimal6_cuda(*args)
    sub, _ = minimal6_cuda(*args, ('dlt', 'epnp'))
    assert torch.equal(sub, torch.cat((full[:, :20], full[:, 40:]), 1))
    assert ransac.hypothesis_solver(cuda) is minimal6_cuda
    Kc, P3, uv = args
    before = minimal6_cuda.launches
    res = ransac.ransac_pnp(Kc, P3.reshape(4, -1, 3), uv.reshape(4, -1, 2),
                            torch.Generator(device=cuda).manual_seed(0),
                            num_hypotheses=16)
    torch.cuda.synchronize()
    assert minimal6_cuda.launches == before + 1
    assert res.pose7.shape == (4, 7)
    plain = fast_minimal.minimal6(*args, ('dlt', 'epnp'))[0]
    assert plain.shape == sub.shape


def test_minimal6_rejects_cpu_and_bad_dtype(cuda):
    from lc_tpu_torch.pnp.minimal6_kernel import minimal6_cuda
    args = minimal_samples(2, 4, 0.0, False, seed=4, device=cuda)
    with pytest.raises(ValueError):
        minimal6_cuda(*[a.cpu() for a in args])
    with pytest.raises(TypeError):
        minimal6_cuda(args[0], args[1].double(), args[2])
    with pytest.raises(ValueError):
        minimal6_cuda(args[0], args[1][:, :, :5].contiguous(),
                      args[2][:, :, :5].contiguous())
