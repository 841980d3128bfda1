"""Where the data-parallel training step's time goes on one card.

    python3 perf_scripts/dp_step_profile.py

Needs a CUDA card; run it from the repository's root. One glmo training
step (CDPN-ResNet34 at 256² in, 64² out, 32 rendered crops, bf16
convolutions, device_rotate, the LC loss and the clip tap), staged in line
as chip_smoke's phase 6 stages it, three ways in this process: alone (no
data-parallel context); inside a one-rank NCCL group (train(...,
parallel=group)'s path: BatchNorm's statistics, the losses' means and the
clip norms through collectives, one flat gradient all-reduce); and the
same with torch.distributed.all_reduce made the identity (what a one-rank
all-reduce computes) so the collectives' own cost drops out. For each:
the median of 5 synchronized steps after 3 warm-up steps (host clock),
then chip_smoke.train_stage_breakdown of one more step, and the
profiler's count of host calls that wait for the device (the CUDA
runtime's synchronize calls) and of collectives. Prints one JSON line per
variant, the card line first.
"""
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402


def main():
    import torch
    import torch.distributed as dist
    from types import SimpleNamespace
    from torch.profiler import ProfilerActivity, profile
    from lc_tpu_torch import cuda_build, harness, resolve_device
    from lc_tpu_torch.data import synthetic
    from lc_tpu_torch.data.pipeline import collate
    from lc_tpu_torch.loss.loss_fn import init_loss_state
    from lc_tpu_torch.models import set_compute_dtype
    from lc_tpu_torch.optim.factory import build_optimizer
    from lc_tpu_torch.parallel import mesh
    from lc_tpu_torch.train import sample_offset
    from lc_tpu_torch.train_step import train_step
    print(cs.card_line(), flush=True)
    cuda_build.build_all()
    device = resolve_device('cuda')
    path, bs = cs.GLMO, cs.GLMO['batch_size']
    cfg = cs.family_train_cfg('glmo')
    ds = cfg.train_dataset
    batch = collate(synthetic.render_train_set(
        bs, seed=21, net_input_wh=path['net_input_wh'],
        net_output_wh=path['net_output_wh'],
        dzi_scale_ratio=ds.dzi_scale_ratio, dzi_shift_ratio=ds.dzi_shift_ratio,
        dzi_pad_scale=ds.dzi_pad_scale, rotate_prob=ds.rotate_prob,
        switch_bg_prob=ds.switch_bg_prob, pixel_aug_prob=ds.pixel_aug_prob))
    pp = harness.preprocess_kwargs(cfg, SimpleNamespace(
        net_input_wh=path['net_input_wh'],
        net_output_wh=path['net_output_wh'],
        mask_nearest=ds.get('mask_interp', 'linear') == 'nearest'),
        train=True)
    loss_cfg = harness.make_loss_config(cfg, 100, None)

    def variant(name, shard):
        model = set_compute_dtype(cs.path_model(path).to(device),
                                  torch.bfloat16)
        opt, sched = build_optimizer(model.parameters(), cfg.optimizer,
                                     cfg.scheduler, 100)
        state = [init_loss_state(loss_cfg, device)]

        def one(step):
            with mesh.data_parallel(shard):
                state[0], m = train_step(
                    model, opt, sched, loss_cfg, state[0],
                    cs.staged_in_line(batch, 42, step, device, pp), step,
                    sample_offset(42, step, loss_cfg.dense_sample))
            return m

        for step in range(3):
            float(one(step)['loss'])
        times = []
        for step in range(3, 8):
            torch.cuda.synchronize()
            t = time.perf_counter()
            float(one(step)['loss'])
            times.append((time.perf_counter() - t) * 1e3)
        stages = cs.train_stage_breakdown(lambda: one(8))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            float(one(9)['loss'])
        calls = {}
        for e in prof.events():
            if 'ynchronize' in e.name or e.name.startswith(('c10d::', 'nccl')):
                calls[e.name] = calls.get(e.name, 0) + 1
        rep = dict(variant=name, step_ms=times,
                   median_step_ms=statistics.median(times),
                   host_calls=calls, stages=stages)
        print(json.dumps(rep), flush=True)

    variant('one_process', None)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group('nccl', store=dist.FileStore(
            os.path.join(tmp, 'store'), 1), rank=0, world_size=1)
        try:
            shard = mesh.shard_of(dist.group.WORLD)
            variant('nccl_one_rank', shard)
            real = dist.all_reduce
            dist.all_reduce = lambda tensor, *a, **k: None
            try:
                variant('nccl_one_rank_all_reduce_identity', shard)
            finally:
                dist.all_reduce = real
        finally:
            dist.destroy_process_group()


if __name__ == '__main__':
    main()
