"""Build the port's CUDA sources with nvcc into shared libraries with a plain C
interface, loaded with ctypes.

Each `csrc/<name>.cu` compiles at first use into `lc_tpu_torch/build/`
(listed in .gitignore), under a file name keyed by the source's hash and the
flags, so an edited source is rebuilt and a built one is reused. `build_all`
starts one nvcc per source, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading

CSRC = osp.join(osp.dirname(osp.abspath(__file__)), 'csrc')
BUILD_DIR = osp.join(osp.dirname(osp.abspath(__file__)), 'build')
# sm_90a: Hopper. No fast-math: parity with the plain versions needs IEEE
# division and square root.
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
SOURCES = ('lm_refine', 'shear_x', 'minimal6')
# per-source flags: the LM refiner and the minimal-sample solvers round
# every multiply and add on its own, as their plain versions do (no
# multiply-add contraction; see the sources' notes)
EXTRA_FLAGS = {'lm_refine': ('-fmad=false',), 'minimal6': ('-fmad=false',)}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (osp.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc'):
        if cand and osp.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the CUDA kernels build from source at first use')


def flags(name: str) -> list[str]:
    return [*NVCC_FLAGS, *EXTRA_FLAGS.get(name, ())]


def library_path(name: str) -> str:
    with open(osp.join(CSRC, f'{name}.cu'), 'rb') as f:
        digest = hashlib.sha1(f.read() + ' '.join(flags(name)).encode())
    return osp.join(BUILD_DIR, f'lib{name}_{digest.hexdigest()[:12]}.so')


def _start(name: str):
    out = library_path(name)
    if osp.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [find_nvcc(), *flags(name), '-o', tmp, osp.join(CSRC, f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp, cmd)


def _finish(name: str, out: str, job) -> str:
    if job is None:
        return out
    proc, tmp, cmd = job
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name} (exit {proc.returncode}):\n'
                           f'{" ".join(cmd)}\n{log}')
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every named source that is not built yet, one nvcc each, all
    started together. Returns {name: library path}."""
    started = {n: _start(n) for n in names}
    try:
        return {n: _finish(n, out, job) for n, (out, job) in started.items()}
    finally:   # after a failed build, stop the ones still compiling
        for _, job in started.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
