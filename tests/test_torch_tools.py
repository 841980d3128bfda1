"""The port's host-side tools against lc_tpu's: data/mesh (PLY meshes and
the software depth rasterizer), `python -m lc_tpu_torch.tools.gen_z` and
`.preflight` (copies of tools/gen_z.py and tools/preflight.py, which import
lc_tpu and so jax), utils/vis, and the TensorBoard scalars of the train CLI.

Tolerances: none. The tools are numpy copies, so every array, z_crop blob
and report row is equal (the preflight hint names the port's gen_z); the
TensorBoard scalars are the metrics.jsonl values at lc_tpu's steps.
"""
import gzip
import os
import os.path as osp
import pickle
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
import yaml
from scipy.spatial.transform import Rotation as sciR

from lc_tpu.data import mesh as jmesh
from lc_tpu.data import synthetic as jsynthetic
from lc_tpu.utils import vis as jvis
from lc_tpu_torch.data import mesh
from lc_tpu_torch.data import synthetic
from lc_tpu_torch.tools import gen_z, preflight
from lc_tpu_torch.utils import vis

from test_torch_train_step import tiny_cfg

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _write_binary_ply(path, verts, faces):
    with open(path, 'wb') as f:
        f.write(('ply\nformat binary_little_endian 1.0\n'
                 f'element vertex {len(verts)}\nproperty float x\n'
                 'property float y\nproperty float z\n'
                 f'element face {len(faces)}\n'
                 'property list uchar int vertex_indices\nend_header\n')
                .encode())
        f.write(np.asarray(verts, '<f4').tobytes())
        for tri in faces:
            f.write(struct.pack('<B3i', 3, *map(int, tri)))


@pytest.mark.parametrize('fmt', ['ascii', 'binary'])
def test_mesh_matches_lc_tpu(tmp_path, fmt):
    """load_ply_mesh reads the box mesh, ascii (generate_dataset's model
    file) or binary, as lc_tpu's does; rasterize_depth gives its depth map
    bit for bit."""
    verts, faces = synthetic.box_mesh(np.array([40.0, 30.0, 20.0]))
    path = str(tmp_path / 'box.ply')
    if fmt == 'ascii':
        synthetic._write_ply_mesh_ascii(path, verts, faces)
    else:
        _write_binary_ply(path, verts, faces)
    v, f = mesh.load_ply_mesh(path)
    jv, jf = jmesh.load_ply_mesh(path)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert v.dtype == jv.dtype and f.dtype == jf.dtype
    K = synthetic.K_DEFAULT.astype(np.float64)
    R = sciR.random(random_state=3).as_matrix()
    t = np.array([10.0, -5.0, 650.0])
    depth = mesh.rasterize_depth(v, f, K, R, t)
    np.testing.assert_array_equal(depth, jmesh.rasterize_depth(jv, jf, K, R, t))
    assert (depth > 0).sum() > 1000


def _blobs(split_dir):
    out = {}
    for d, _, fs in os.walk(osp.join(split_dir, 'z_crop')):
        for name in fs:
            with gzip.open(osp.join(d, name)) as fh:
                out[osp.relpath(osp.join(d, name), split_dir)] = pickle.load(fh)
    return out


def test_gen_z_matches_tools_gen_z(tmp_path):
    """`python -m lc_tpu_torch.tools.gen_z --data_dir <split> --scene 1`
    writes the .pkl.gz files tools/gen_z.py writes, with equal contents
    (the case of tests/test_eval_and_tools.py::TestGenZCLI)."""
    trees = []
    for name in ('port', 'lc_tpu'):
        root = str(tmp_path / name)
        synthetic.generate_dataset(root, n_images=2, split='train_syn', seed=0)
        split_dir = osp.join(root, 'train_syn')
        shutil.rmtree(osp.join(split_dir, 'z_crop'))
        trees.append(split_dir)
    gen_z.main(['--data_dir', trees[0], '--scene', '1'])
    out = subprocess.run(
        [sys.executable, osp.join(ROOT, 'tools', 'gen_z.py'), '--data_dir',
         trees[1], '--scene', '1'],
        capture_output=True, text=True, env=dict(os.environ,
                                                 JAX_PLATFORMS='cpu'))
    assert out.returncode == 0, out.stderr
    ours, theirs = _blobs(trees[0]), _blobs(trees[1])
    assert sorted(ours) == sorted(theirs) and len(ours) == 2
    for k, blob in theirs.items():
        assert set(ours[k]) == set(blob)
        np.testing.assert_array_equal(ours[k]['z_crop'], blob['z_crop'])
        assert ours[k]['z_crop'].dtype == blob['z_crop'].dtype
        for key in ('xyxy', 'z_min', 'z_max'):
            assert ours[k][key] == blob[key], key


def _lc_tpu_preflight():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'lc_tpu_preflight', osp.join(ROOT, 'tools', 'preflight.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(rep):
    return [(ok, required, what, detail.replace(
        'python -m lc_tpu_torch.tools.gen_z', 'python tools/gen_z.py'))
        for ok, required, what, detail in rep.rows]


@pytest.mark.parametrize('missing', [False, True])
def test_preflight_matches_tools_preflight(tmp_path, missing):
    """The port's preflight reports tools/preflight.py's rows on the
    synthetic tree (every required artifact present) and on a tree without
    its z_crop patches and eval mesh (both REQUIRED-missing, 2 in all),
    the same but for the gen_z command its hint names; the CLI's exit code
    says which (the cases of tests/test_eval_and_tools.py::TestPreflight)."""
    root = str(tmp_path / 'bop')
    jsynthetic.generate_dataset(root, n_images=3, split='train_syn', seed=0)
    jsynthetic.generate_dataset(root, n_images=2, split='test_syn', seed=5,
                                list_name='test_list.txt')
    if missing:
        shutil.rmtree(osp.join(root, 'train_syn', 'z_crop'))
        os.remove(osp.join(root, 'models_eval', 'obj_000001.ply'))
    cfg = jsynthetic.default_train_cfg(root)
    from lc_tpu_torch.utils.config import Config
    rep = preflight.preflight(Config(_plain(cfg)), obj_ids=[1])
    jrep = _lc_tpu_preflight().preflight(cfg, obj_ids=[1])
    assert _rows(rep) == list(jrep.rows)
    assert rep.n_missing_required == jrep.n_missing_required \
        == (2 if missing else 0)
    cfg_path = str(tmp_path / 'syn.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(_plain(cfg), f)
    r = subprocess.run([sys.executable, '-m', 'lc_tpu_torch.tools.preflight',
                        '--config', cfg_path, '--obj', '1'],
                       capture_output=True, text=True, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == (1 if missing else 0), r.stdout + r.stderr
    assert f'{rep.n_missing_required} REQUIRED artifact(s) missing' in r.stdout


def test_vis_matches_lc_tpu():
    """Every drawing and colormap of utils/vis equals lc_tpu's (the case of
    tests/test_eval_and_tools.py::TestVis)."""
    img = np.full((120, 160, 3), 32, np.uint8)
    K = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])
    R = sciR.random(random_state=2).as_matrix()
    t = np.array([0, 0, 600.0])
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float64) * [40.0, 30.0, 20.0]
    rng = np.random.default_rng(7)
    noc = np.clip(rng.normal(size=(16, 16, 3)), -1, 1)
    msk = rng.random((16, 16)) > 0.5
    w = rng.random((16, 16))
    over = rng.random(img.shape[:2]) > 0.5
    for name, args in (('project_points', (corners, R, t, K)),
                       ('draw_bbox3d', (img, corners, R, t, K)),
                       ('draw_pose_axes', (img, R, t, K, 30.0)),
                       ('noc_to_rgb', (noc, msk)),
                       ('weight_heatmap', (w,)),
                       ('overlay_mask', (img, over))):
        ours, theirs = getattr(vis, name)(*args), getattr(jvis, name)(*args)
        assert ours.dtype == theirs.dtype, name
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    assert (vis.draw_bbox3d(img, corners, R, t, K) != img).any()


def _scalars(event_file):
    """{tag: [(step, value)]} of a TensorBoard event file (TFRecord
    framing: length, its CRC, the Event proto, its CRC)."""
    from tensorboardX.proto import event_pb2
    out = {}
    with open(event_file, 'rb') as f:
        while header := f.read(12):
            (n,) = struct.unpack('<Q', header[:8])
            event = event_pb2.Event.FromString(f.read(n))
            f.read(4)
            for v in event.summary.value:
                out.setdefault(v.tag, []).append((event.step, v.simple_value))
    return out


def test_train_cli_tensorboard_scalars(tree, tmp_path):
    """A 21-step CPU train run with an evaluation after step 20 writes
    loss/<term> at steps 1 and 20 and eval/score at 20: where lc_tpu writes
    them (lc_tpu/train.py: every 20th step and the first; after each
    evaluation), with metrics.jsonl's values, which also has the last step."""
    from lc_tpu_torch import train as train_cli
    cfg = tiny_cfg(tree, **{'train.num_steps': 21, 'train.test_every': 20,
                            'train.ckpt_every': 100})
    cfg_path = tmp_path / 'tiny.yaml'
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    try:
        train_cli.main(['--config', str(cfg_path), '--device', 'cpu',
                        '--output', str(tmp_path / 'out')])
        _check_scalars(tmp_path / 'out' / 'syn-1')
    finally:   # the run's checkpoints hold ~0.5 GB
        shutil.rmtree(tmp_path / 'out', ignore_errors=True)


def _check_scalars(exp):
    import json
    events = list(exp.glob('events.out.tfevents.*'))
    assert len(events) == 1
    scalars = _scalars(events[0])
    lines = {m['step']: m for m in map(
        json.loads, (exp / 'metrics.jsonl').read_text().splitlines())}
    assert sorted(lines) == [1, 20, 21]
    terms = sorted(k for k in lines[1] if k != 'step')
    assert sorted(scalars) == sorted(['eval/score']
                                     + [f'loss/{k}' for k in terms])
    for k in terms:
        assert [s for s, _ in scalars[f'loss/{k}']] == [1, 20]
        for s, v in scalars[f'loss/{k}']:
            assert v == pytest.approx(lines[s][k], rel=1e-6)
    assert [s for s, _ in scalars['eval/score']] == [20]


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """A generated BOP tree (8 training frames, 4 test frames) and two
    background images, as tests/test_torch_train_step.py's."""
    import cv2
    root = tmp_path_factory.mktemp('syn')
    jsynthetic.generate_dataset(str(root), n_images=8, split='train_syn',
                                seed=0)
    jsynthetic.generate_dataset(str(root), n_images=4, split='test_syn',
                                seed=1, list_name='test_list.txt')
    bg = root / 'bg'
    bg.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        cv2.imwrite(str(bg / f'{i}.png'),
                    rng.integers(0, 256, (96, 128, 3)).astype(np.uint8))
    return str(root)
