"""Card-only tests of the port's CUDA kernel against its plain version. They
import no jax, so they also run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA device every test here skips. Tolerance (that of
tests/test_pallas_lm.py): translation atol 0.05 mm, |q·q'| > 1 − 1e-5, cost
rtol 1e-3, identical invalid flags."""
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


@pytest.mark.parametrize('case', ['final_refine', 'polish', 'edges_N1000'])
def test_kernel_matches_plain(cuda, case):
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    N = 1000 if case == 'edges_N1000' else 1024
    args = make_problem(32, N, seed=3, device=cuda,
                        per_coord=case != 'polish')
    kw = dict(max_iter=10, fallback_to_init=False) if case == 'polish' \
        else dict(max_iter=50, fallback_to_init=True)
    if case == 'polish':
        args[4] = torch.ones_like(args[4])
    if case == 'edges_N1000':
        args[5][0, 2:] = False
    before = lm_refine_cuda.launches
    out = lm_refine_auto(*args, **kw)
    torch.cuda.synchronize()
    assert lm_refine_cuda.launches == before + 1
    _agree(out, lm_refine(*args, **kw))
    if case == 'edges_N1000':
        assert bool(out.invalid[0]) and torch.equal(out.pose7[0], args[0][0])


def test_kernel_rejects_cpu_and_bad_dtype(cuda):
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    args = make_problem(2, 16, seed=4, device=cuda)
    with pytest.raises(ValueError):
        lm_refine_cuda(*[a.cpu() for a in args])
    args[2] = args[2].double()
    with pytest.raises(TypeError):
        lm_refine_cuda(*args)
