"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` is compiled by hand with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries go into
``pqdet_tpu_torch/_build/`` (git-ignored), named by a hash of their source
and flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built at import: the first kernel launch builds what it needs,
and ``build_all`` builds every source at once, one ``nvcc`` each, started
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v']

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob('*.cu'))


def nvcc() -> str:
    cand = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                           'the CUDA kernels are built on the machine with the card')
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f'{name}.cu').read_bytes()
    tag = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'lib{name}_{tag}.so'


def build_all() -> Dict[str, dict]:
    """Compile every ``csrc/*.cu`` that has no current library, one nvcc
    process per source, all started together. Returns per source
    ``{'path', 'seconds', 'log'}`` (``log`` holds ptxas's register and
    shared-memory report); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in sources():
        out = library_path(name)
        if out.exists():
            procs[name] = (out, None)
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / f'{name}.cu')]
        procs[name] = (out, (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report, failed = {}, []
    for name, (out, job) in procs.items():
        if job is None:
            report[name] = {'path': str(out), 'seconds': 0.0, 'log': 'cached'}
            continue
        tmp, proc = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc exit {proc.returncode}\n{log}')
            continue
        os.replace(tmp, out)
        report[name] = {'path': str(out), 'seconds': time.perf_counter() - t0, 'log': log}
    if failed:
        raise RuntimeError('CUDA build failed:\n' + '\n'.join(failed))
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
