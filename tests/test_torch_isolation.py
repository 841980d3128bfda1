"""The PyTorch port stands alone: no jax/flax/optax/msgpack/lc_tpu import
(nor bench.py or __graft_entry__.py, which import jax) anywhere in
lc_tpu_torch, chip_smoke.py or bench_torch.py (lc_tpu's .ckpt files are read by
the port's own msgpack decoder), and its entry points refuse to fall back to
the CPU when no CUDA device is present."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'lc_tpu', 'bench',
             '__graft_entry__')


def _port_sources():
    files = sorted((ROOT / 'lc_tpu_torch').rglob('*.py'))
    return files + [ROOT / 'chip_smoke.py', ROOT / 'bench_torch.py',
                    ROOT / 'perf_scripts' / 'learned_syn.py']


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path} imports {bad}'


def test_import_pulls_in_no_jax():
    code = ('import sys\n'
            'import lc_tpu_torch.harness, lc_tpu_torch.test, '
            'lc_tpu_torch.inference, lc_tpu_torch.train, '
            'lc_tpu_torch.parallel.mesh, lc_tpu_torch.tools.gen_z, '
            'lc_tpu_torch.tools.preflight, lc_tpu_torch.utils.vis, '
            'lc_tpu_torch.data.mesh, lc_tpu_torch.utils.profiling, '
            'bench_torch\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            f'{FORBIDDEN!r}]\n'
            'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, '-c', code], check=True, env=env,
                   cwd=ROOT, timeout=120)


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; this checks the refusal path')


def test_entry_points_raise_without_cuda():
    _require_no_cuda()
    from lc_tpu_torch import harness, inference, resolve_device
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device()
    with pytest.raises(RuntimeError, match='CUDA'):
        inference.solve_pnp_dense({}, {})
    with pytest.raises(RuntimeError, match='CUDA'):
        harness.run_test(None, None, [], None, None)
    assert resolve_device('cpu') == torch.device('cpu')


def test_cli_raises_without_cuda(tmp_path):
    _require_no_cuda()
    from lc_tpu_torch import test as cli
    with pytest.raises(RuntimeError, match='CUDA'):
        cli.main(['--weight', 'w.pth', '--config', 'c.yaml', '--output',
                  str(tmp_path), '--obj', '1'])


def test_train_cli_raises_without_cuda(tmp_path):
    """python -m lc_tpu_torch.train refuses to fall back to the CPU: it
    raises before reading its config unless --device cpu is given."""
    _require_no_cuda()
    from lc_tpu_torch import train as cli
    from lc_tpu_torch.train import build_training
    with pytest.raises(RuntimeError, match='CUDA'):
        cli.main(['--config', 'c.yaml', '--output', str(tmp_path)])
    with pytest.raises(RuntimeError, match='CUDA'):
        build_training(None)


@pytest.mark.parametrize('cli', ['train', 'test'])
def test_clis_under_torchrun_raise_without_cuda(tmp_path, monkeypatch, cli):
    """Under torchrun's environment the train and test CLIs still refuse
    to fall back to the CPU: they raise before joining a process group
    unless --device cpu is given."""
    _require_no_cuda()
    import importlib
    import torch.distributed as dist
    for k, v in (('RANK', '0'), ('LOCAL_RANK', '0'), ('WORLD_SIZE', '2'),
                 ('MASTER_ADDR', '127.0.0.1'), ('MASTER_PORT', '1')):
        monkeypatch.setenv(k, v)
    mod = importlib.import_module(f'lc_tpu_torch.{cli}')
    argv = ['--config', 'c.yaml', '--output', str(tmp_path)]
    if cli == 'test':
        argv += ['--weight', 'w.pth', '--obj', '1']
    with pytest.raises(RuntimeError, match='CUDA'):
        mod.main(argv)
    assert not dist.is_initialized()


@pytest.mark.parametrize('tool', ['gen_z', 'preflight'])
def test_tools_are_host_only(tool):
    """python -m lc_tpu_torch.tools.<tool> takes no --device and needs no
    CUDA (tests/test_torch_tools.py runs them here)."""
    import importlib
    mod = importlib.import_module(f'lc_tpu_torch.tools.{tool}')
    with pytest.raises(SystemExit) as e:
        mod.main(['--help'])
    assert e.value.code == 0
