"""The port's process-pool loader (data/pipeline.py::MPLoader) against
lc_tpu's on one generated BOP tree.

Tolerance: none. Every host field of every batch is bit-equal, because both
packages run the same numpy/cv2 code on the same per-row generators
(seed, epoch, batch index, global row). The threaded Loader gives the same
batches, so the stream does not depend on threads or processes.

lc_tpu's pool takes the default start method, fork; here its workers start
from a forkserver: a fork of a test process that earlier tests' torch work
left with live thread pools can inherit one of their locks held and hang
(this file run after tests/test_torch_quant.py and test_torch_ransac.py in
one process did).
"""
import numpy as np
import pytest

from lc_tpu.data.pipeline import BOPDataset as JDataset
from lc_tpu.data.pipeline import MPLoader as JMPLoader
from lc_tpu.data import synthetic as jsynthetic
from lc_tpu_torch.data.pipeline import BOPDataset, Loader, MPLoader
from test_torch_train_step import _jcfg, tiny_cfg


@pytest.fixture(autouse=True)
def _pools_start_from_a_forkserver():
    import multiprocessing
    old = multiprocessing.get_start_method(allow_none=True)
    multiprocessing.set_start_method('forkserver', force=True)
    try:
        yield
    finally:
        multiprocessing.set_start_method(old, force=True)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """8 training frames (2 batches of 4 an epoch) and a background."""
    import cv2
    root = tmp_path_factory.mktemp('mp')
    jsynthetic.generate_dataset(str(root), n_images=8, split='train_syn',
                                seed=0)
    (root / 'bg').mkdir()
    cv2.imwrite(str(root / 'bg' / '0.png'), np.random.default_rng(0).integers(
        0, 256, (96, 128, 3)).astype(np.uint8))
    return str(root)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _port(cfg, **kw):
    return MPLoader(cfg.train_dataset, cfg, batch_size=4, train=True,
                    seed=3, num_workers=2, **kw)


@pytest.mark.parametrize('mode', [{}, {'dataloader.device_rotate': True}],
                         ids=['host_warp', 'device_rotate'])
def test_batches_equal_lc_tpu_and_threaded_loader(tree, mode):
    """One epoch through __iter__, then endless() across the epoch
    boundary: lc_tpu's MPLoader, the port's, and the port's threaded Loader
    give the same batches."""
    cfg = tiny_cfg(tree, **mode)
    jcfg = _jcfg(cfg)
    ref = JMPLoader(jcfg.train_dataset, jcfg, batch_size=4, train=True,
                    seed=3, num_workers=2)
    got = _port(cfg)
    try:
        assert len(got) == len(ref) == 2
        want = list(iter(ref))
        it = ref.endless(start=1)
        want += [next(it) for _ in range(3)]
        have = list(iter(got))
        it = got.endless(start=1)
        have += [next(it) for _ in range(3)]
        threads = Loader(BOPDataset(cfg.train_dataset, cfg, train=True), 4,
                         seed=3, num_threads=2)
        threaded = [b for _ in range(3) for b in threads][:5]
    finally:
        ref.close()
        got.close()
    for a, b in zip(want, have):
        _equal(a, b)
    for a, b in zip(threaded, have[:2] + have[3:]):
        _equal(a, b)


def test_iter_is_endless_and_resume_is_exact(tree):
    """__iter__ and endless() draw the same batches for one epoch, and
    endless(start=3) repeats the uninterrupted stream from batch 3 (the
    cases of tests/test_data.py::TestMPLoader)."""
    loader = _port(tiny_cfg(tree), prefetch=2)
    try:
        epoch = list(iter(loader))
        it = loader.endless()
        seq = [next(it) for _ in range(5)]
        it2 = loader.endless(start=3)
        resumed = [next(it2) for _ in range(2)]
    finally:
        loader.close()
    for a, b in zip(epoch, seq):
        _equal(a, b)
    for a, b in zip(seq[3:], resumed):
        _equal(a, b)


def test_carved_streams_union_is_global(tree):
    """Two carved streams (process_index 0 and 1 of 2) hold two rows each
    of every global batch, and their union is the global stream (the case
    of tests/test_data.py::test_mploader_union_matches_global)."""
    cfg = tiny_cfg(tree)
    loaders = [_port(cfg, process_index=i, process_count=c)
               for i, c in ((0, 1), (0, 2), (1, 2))]
    try:
        its = [x.endless() for x in loaders]
        rows = [[next(it) for _ in range(4)] for it in its]
    finally:
        for x in loaders:
            x.close()
    for g, a, b in zip(*rows):
        assert len(a['im_id']) == len(b['im_id']) == 2
        for k in g:
            np.testing.assert_array_equal(np.concatenate((a[k], b[k])), g[k])


def test_sharding_checks_and_dataset_metadata(tree):
    """The loader's own dataset carries the metadata (sizes, bit_cnt) the
    caller reads; an indivisible batch raises before a pool starts."""
    cfg = tiny_cfg(tree)
    jds = JDataset(_jcfg(cfg).train_dataset, _jcfg(cfg), train=True)
    with pytest.raises(ValueError, match='divisible'):
        _port(cfg, process_count=3)
    loader = _port(cfg)
    try:
        assert len(loader.ds) == len(jds) == 8
        assert loader.ds.net_input_wh == tuple(jds.net_input_wh)
        assert loader.ds.bit_cnt == jds.bit_cnt
    finally:
        loader.close()


def test_train_cli_streams_resumes_and_closes(tree, tmp_path, monkeypatch):
    """python -m lc_tpu_torch.train --device cpu with dataloader.multiprocess
    for 3 steps; a run cut before its third step and resumed from its
    step-2 checkpoint (MPLoader.endless(2)) repeats the third step's
    metrics exactly; each run closes its pool, the cut one too."""
    import json
    import yaml
    from lc_tpu_torch import train as train_cli
    cfg = tiny_cfg(tree, **{'dataloader.multiprocess': True,
                            'train.test_every': 0})
    cfg_path = tmp_path / 'mp.yaml'
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    base = ['--config', str(cfg_path), '--device', 'cpu']
    closed = []
    real_close = MPLoader.close

    def close(self):
        closed.append(self)
        real_close(self)
    monkeypatch.setattr(MPLoader, 'close', close)

    def metrics(out):
        return [json.loads(x) for x in
                (out / 'syn-1' / 'metrics.jsonl').read_text().splitlines()]

    train_cli.main(base + ['--output', str(tmp_path / 'a')])
    real_step = train_cli.train_step

    def cut_at_third(*args, **kw):
        if args[6] == 2:
            raise KeyboardInterrupt('cut')
        return real_step(*args, **kw)

    monkeypatch.setattr(train_cli, 'train_step', cut_at_third)
    with pytest.raises(KeyboardInterrupt):
        train_cli.main(base + ['--output', str(tmp_path / 'b')])
    monkeypatch.setattr(train_cli, 'train_step', real_step)
    train_cli.main(base + ['--output', str(tmp_path / 'b'), '--resume'])
    assert [m['step'] for m in metrics(tmp_path / 'a')] == [1, 3]
    assert metrics(tmp_path / 'b')[-1] == metrics(tmp_path / 'a')[-1]
    assert len(closed) == 3
    assert all(not x._pool._processes for x in closed)
