"""Planted faults against chip_smoke.py's resume and data-parallel checks.

    python3 perf_scripts/dp_fault_gaps.py

Needs a CUDA card; run it from the repository's root. On chip_smoke's
glmo train CLI tree (glmo's widths, global batch 32, device_rotate, six
steps, an evaluation after step 3):

1. the train CLI once, then resumed from its step-3 checkpoint three ways:
   as it is, with the optimizer's state not restored, and with the loss
   state's clip thresholds not restored (each a fault a resume can have);
   for each, what chip_smoke.held_resumed reads: where the state entering
   step 4 differs from the uninterrupted run's, step 4's loss terms (both
   held bit for bit) and step 6's loss (held to RERUN_RTOL);
2. chip_smoke.phase_data_parallel as it is, and with BatchNorm taking
   each rank's local statistics (nn.BatchNorm2d's one-process call, the
   fault a naive data-parallel wrap makes), with chip_smoke.check
   recording each failed check instead of stopping the run: the gaps of
   every run and every check that failed.

Prints one JSON line per run and writes every failed check under
chiprun_out/dp_fault_gaps/.
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

OUT = os.path.join('chiprun_out', 'dp_fault_gaps')
FAULT = os.environ.get('DP_FAULT', '')


def recording_check(cond, msg):
    """chip_smoke.check that records a failure and goes on."""
    if not cond:
        with open(os.path.join(OUT, f'failed_{FAULT or "none"}_'
                               f'{os.getpid()}.txt'), 'a') as f:
            f.write(msg + '\n')


def local_batch_norm():
    """BatchNorm with each rank's own statistics in every mode."""
    from torch import nn
    from lc_tpu_torch.models import layers
    layers.BatchNorm2d.forward = lambda self, x: nn.BatchNorm2d.forward(
        self, layers.at_least_f32(x))


# also in the gloo ranks, which spawn re-runs this module's top level in
cs.check = recording_check
if FAULT == 'local_bn':
    local_batch_norm()


def resume_faults(cfg_path: str, tmp: str) -> dict:
    import glob
    import torch
    from lc_tpu_torch import train as train_cli
    from lc_tpu_torch.loss.clip import init_clipper_state
    with cs.recorded_steps(train_cli, snapshot_step=3) as rec:
        train_cli.main(['--config', cfg_path, '--output',
                        os.path.join(tmp, 'ref')])
    ref = cs.steps_report(rec, cs.GLMO['batch_size'])['steps']
    ref_state = rec['state']
    step3, = glob.glob(os.path.join(tmp, 'ref', 'glmo-1',
                                    'model_best_3_*.ckpt'))
    real_opt = torch.optim.Optimizer.load_state_dict
    real_loss_state = train_cli.loss_state_to

    def no_clip(state, device):
        return real_loss_state(state, device)._replace(**{
            k: init_clipper_state(device)
            for k in ('weight_clip', 'scale_clip', 'pts_clip')})

    out = {}
    for fault in ('none', 'optimizer_state', 'clip_state'):
        if fault == 'optimizer_state':
            torch.optim.Optimizer.load_state_dict = lambda self, sd: None
        if fault == 'clip_state':
            train_cli.loss_state_to = no_clip
        try:
            with cs.recorded_steps(train_cli, snapshot_step=3) as rec:
                train_cli.main(['--config', cfg_path, '--output',
                                os.path.join(tmp, f'resumed_{fault}'),
                                '--ckpt', step3])
        finally:
            torch.optim.Optimizer.load_state_dict = real_opt
            train_cli.loss_state_to = real_loss_state
        resumed = cs.steps_report(rec, cs.GLMO['batch_size'])['steps']
        step4 = {k: abs(resumed[0][k] - ref[3][k]) / abs(ref[3][k])
                 for k in ref[3] if k != 'grad_norm'}
        diff = cs.state_diff(rec['state'], ref_state)
        out[fault] = dict(
            state_differs_at=len(diff), first_differences=diff[:4],
            step4_loss_term_gaps=step4,
            step6_loss_gap=abs(resumed[-1]['loss'] - ref[-1]['loss'])
            / abs(ref[-1]['loss']),
            held_by_step4=any(v > 0 for v in step4.values()),
            held_by_step6=abs(resumed[-1]['loss'] - ref[-1]['loss'])
            > cs.RERUN_RTOL * abs(ref[-1]['loss']))
        print(json.dumps(dict(resume=fault, **out[fault])), flush=True)
    return out


def data_parallel(cfg_path: str, tmp: str, device) -> dict:
    from lc_tpu_torch import train as train_cli
    with cs.recorded_steps(train_cli) as rec:
        train_cli.main(['--config', cfg_path, '--output',
                        os.path.join(tmp, 'plain')])
    plain = cs.steps_report(rec, cs.GLMO['batch_size'])
    t0 = time.perf_counter()
    try:
        rep = cs.phase_data_parallel(cfg_path, tmp, plain, device, [])
        error = None
    except Exception as e:      # a later step that a failed check broke
        rep, error = None, f'{type(e).__name__}: {e}'
    failed = []
    for name in sorted(os.listdir(OUT)):
        if name.startswith(f'failed_{FAULT or "none"}_'):
            with open(os.path.join(OUT, name)) as f:
                failed += f.read().splitlines()
    summary = dict(fault=FAULT or 'none', seconds=time.perf_counter() - t0,
                   failed_checks=failed, error=error)
    if rep is not None:
        summary.update(
            nccl1_gaps=rep['nccl1']['gaps'], gloo2_gaps=rep['gloo2']['gaps'],
            nccl1_f64=rep['nccl1']['f64_step'],
            gloo2_f64=rep['gloo2']['f64_step'],
            train_step_ms=dict(plain=plain['train_step_ms'],
                               no_prefetch=rep['no_prefetch']['train_step_ms'],
                               nccl1=rep['nccl1']['train_step_ms'],
                               gloo2=rep['gloo2']['train_step_ms']),
            no_prefetch=rep['no_prefetch'])
    print(json.dumps(summary), flush=True)
    return summary


def main():
    import subprocess
    from lc_tpu_torch import cuda_build, resolve_device
    os.makedirs(OUT, exist_ok=True)
    device = resolve_device('cuda')
    if not FAULT:
        print(cs.card_line(), flush=True)
    cuda_build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        _, cfg_path = cs.glmo_cli_tree(tmp)
        if not FAULT:
            resume_faults(cfg_path, tmp)
        data_parallel(cfg_path, tmp, device)
    if not FAULT:
        # the planted BatchNorm fault in a process of its own (and in its
        # spawned ranks)
        r = subprocess.run([sys.executable, __file__],
                           env=dict(os.environ, DP_FAULT='local_bn'))
        if r.returncode:
            raise SystemExit(r.returncode)
    cs.stop_children()


if __name__ == '__main__':
    main()
