"""Count the operations one single-process training step dispatches.

    python perf_scripts/count_step_ops.py [REPO]

REPO (default: this checkout) is the root of a checkout whose
lc_tpu_torch is imported, so two commits compare by running the script
from each. One CDPN-ResNet34 step on the CPU (the step's input staged as
the train loop stages it in line: the batch as tensors, the train branch
of data/pipeline.device_preprocess with the step's generator, the dense
loss's sampling offset; then train_step) at 64² in, 16² out, batch 4 (rendered device-rotated crops, the LC
loss and the clip tap on), under a TorchDispatchMode that counts every
ATen operation reaching a kernel: the device operations the step issues,
counted where the CPU runs them (a count, not a time). Prints one JSON
line: {"aten_ops": N, "by_op": {...}}.
"""
import collections
import json
import sys
import types

repo = sys.argv[1] if len(sys.argv) > 1 else '.'
sys.path.insert(0, repo)

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from lc_tpu_torch import harness  # noqa: E402
from lc_tpu_torch.data import synthetic  # noqa: E402
from lc_tpu_torch.data.pipeline import collate, device_preprocess  # noqa: E402
from lc_tpu_torch.loss.loss_fn import init_loss_state  # noqa: E402
from lc_tpu_torch.models.weights import init_weights  # noqa: E402
from lc_tpu_torch.optim.factory import build_optimizer  # noqa: E402
from lc_tpu_torch.train_step import train_step  # noqa: E402
from lc_tpu_torch.utils import seeding  # noqa: E402
from lc_tpu_torch.utils.config import Config  # noqa: E402


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def main():
    cfg = Config(dict(
        model=dict(net_name='cdpn_resnet', net_config=dict(concat=False)),
        optimizer=dict(type='Ranger', lr=2e-4, wd=1e-4),
        scheduler=dict(name='none'), train_dataset={},
        loss=dict(pose_loss_cfg=dict(clip_weight_grad=True),
                  pose_loss_start_step=0, w_loss_noc=1.0, w_loss_seg=0.25,
                  w_loss_pose=0.02)))
    wh_in, wh_out = (64, 64), (16, 16)
    batch = collate(synthetic.render_train_set(4, seed=9, net_input_wh=wh_in,
                                               net_output_wh=wh_out))
    model = harness.build_model_from_cfg(cfg)
    init_weights(model, torch.Generator().manual_seed(3))
    loss_cfg = harness.make_loss_config(cfg, 0, None)
    opt, sched = build_optimizer(model.parameters(), cfg.optimizer,
                                 cfg.scheduler, 10)
    pp = harness.preprocess_kwargs(cfg, types.SimpleNamespace(
        net_input_wh=wh_in, net_output_wh=wh_out, mask_nearest=False),
        train=True)
    state = init_loss_state(loss_cfg)
    for step in range(2):           # the second step is the one counted
        counter = Count()
        with counter:
            gt = device_preprocess(
                {k: torch.as_tensor(v) for k, v in batch.items()},
                seeding.step_generator(7, step, seeding.STREAM_PREPROCESS,
                                       'cpu'), **pp)
            top_left = torch.randint(
                0, loss_cfg.dense_sample, (2,),
                generator=seeding.step_generator(
                    7, step, seeding.STREAM_STEP)).tolist()
            state, metrics = train_step(model, opt, sched, loss_cfg, state,
                                        gt, step, top_left)
            float(metrics['loss'])
    print(json.dumps(dict(aten_ops=sum(counter.ops.values()),
                          by_op=dict(sorted(counter.ops.items())))))


if __name__ == '__main__':
    main()
