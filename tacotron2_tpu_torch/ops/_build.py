"""Build and load the port's CUDA kernels.

Every `*.cu` file at the top of `tacotron2_tpu_torch/csrc/` is compiled with nvcc for
Hopper (`sm_90a`) into one shared library with a plain C interface, which is loaded with
ctypes (`load_library`); the measurement probes' sources under `csrc/probes/` go into a
library of their own (`load_probe_library`), so that neither build grows the other.
Each build runs at first use, into `build/tacotron2_tpu_torch/` at the root of the
checkout, and is redone when its sources' hash changes. There is no fallback: a missing
nvcc or a failed build raises.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
PROBES_DIR = os.path.join(CSRC_DIR, 'probes')
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), 'build', 'tacotron2_tpu_torch')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')


def _sources(src_dir: str = CSRC_DIR):
    srcs = sorted(os.path.join(src_dir, f) for f in os.listdir(src_dir)
                  if f.endswith('.cu'))
    if not srcs:
        raise FileNotFoundError(f'no CUDA sources in {src_dir}')
    return srcs


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, 'bin', 'nvcc')] if CUDA_HOME else []
    candidates.append(shutil.which('nvcc'))
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH): the '
                       'port\'s CUDA kernels are built from source at first use')


def compile_library(srcs, lib_path: str, defines=()) -> None:
    """Compile the CUDA sources `srcs` with nvcc into the shared library `lib_path`,
    with the macros `defines` ('NAME' or 'NAME=value') set."""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f'{lib_path}.{os.getpid()}.tmp'
    cmd = [_nvcc(), *NVCC_FLAGS, *[f'-D{d}' for d in defines], '-o', tmp, *srcs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed ({res.returncode}):\n{" ".join(cmd)}\n'
                           f'{res.stdout}\n{res.stderr}')
    os.replace(tmp, lib_path)  # atomic: a concurrent process never loads a partial file


def _load(src_dir: str, stem: str) -> ctypes.CDLL:
    """Compile the sources of `src_dir` (if they changed) into `<stem>-<hash>.so`, and
    load it. The sources include no header of their own."""
    srcs = _sources(src_dir)
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, 'rb') as f:
            digest.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f'{stem}-{digest.hexdigest()[:16]}.so')
    if not os.path.isfile(lib_path):
        compile_library(srcs, lib_path)
    return ctypes.CDLL(lib_path)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile (if the sources changed) and load the kernels' shared library."""
    return _load(CSRC_DIR, 'libt2kernels')


@functools.cache
def load_probe_library() -> ctypes.CDLL:
    """Compile (if the sources changed) and load the probes' shared library."""
    return _load(PROBES_DIR, 'libt2probes')
