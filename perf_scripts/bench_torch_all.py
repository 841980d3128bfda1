"""Every mode of bench_torch.py on the card, in one process, at its default
chain (the same as `python bench_torch.py --mode M` for each M, without a
process start each); `ref` and any mode named in the second argument also
through the script itself.

    python perf_scripts/bench_torch_all.py [mode,mode,...] [cli_mode,...]

Prints the card's name and power limit, the host's CPU count, and one line
a mode with its seconds and chain counts."""
import json
import os
import subprocess
import sys
import time
import traceback

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402


def main(argv):
    print(f'{chip_smoke.card_line()} | {os.cpu_count()} CPUs | torch '
          f'{torch.__version__} cuda {torch.version.cuda}', flush=True)
    modes = argv[0].split(',') if argv else list(bench_torch.MODES)
    cli = argv[1].split(',') if len(argv) > 1 else []
    for mode in cli:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, 'bench_torch.py', '--mode', mode],
                           capture_output=True, text=True, timeout=900,
                           cwd=ROOT)
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ''
        print(f'CLI {mode} rc={p.returncode} {time.perf_counter() - t0:.1f} s '
              f'{last}', flush=True)
        if p.returncode:
            print(p.stderr[-3000:], flush=True)
    for mode in modes:
        if mode == 'ref':
            continue
        run = bench_torch.Run(torch.device('cuda'))
        t0 = time.perf_counter()
        try:
            line = bench_torch.run_mode(mode, run)
        except Exception:   # noqa: BLE001 -- report the mode, go on
            print(f'MODE {mode} FAILED after {time.perf_counter() - t0:.1f} '
                  f's\n{traceback.format_exc()[-3000:]}', flush=True)
            continue
        print(f'MODE {mode} {time.perf_counter() - t0:.1f} s '
              f'{json.dumps(line)} {dict(run.batches)}', flush=True)
        torch.cuda.empty_cache()
    print(chip_smoke.card_line(), flush=True)


if __name__ == '__main__':
    main(sys.argv[1:])
