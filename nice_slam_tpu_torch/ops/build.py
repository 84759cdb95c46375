"""Build the port's native sources into the checkout's `build/` directory.

The CUDA kernels (`csrc/*.cu`) are compiled with nvcc for sm_90a, the host
geometry library (`csrc/geometry.cpp`) with g++; each becomes a shared
library with a plain C interface that its Python module loads with
ctypes.  A library is built at first use and rebuilt when its source is
newer.  Each build writes a temporary file and renames it into place, so
concurrent processes never load a partial library.  `launch` is the one
call path of every kernel wrapper into its library.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build')


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           f'{CSRC} need the CUDA toolkit to build')
    return path


def _compile(cmd_of_output, library: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{library}.{os.getpid()}.tmp'
    cmd = cmd_of_output(tmp)
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'{os.path.basename(cmd[0])} failed '
                           f'({res.returncode}):\n{res.stderr}')
    os.replace(tmp, library)
    return res.stderr


def compile_cuda(source: str, library: str) -> str:
    """nvcc for sm_90a (true FP32 maths: no fast-math flags); returns
    ptxas's register and spill report.  `--split-compile=0` compiles the
    kernels of a source on all the host's cores (fused_mlp.cu's twelve
    instantiations: 14.6 s against 25.2 s on the H100 machine, the same
    code bit for bit; PERF.md section 6)."""
    return _compile(lambda out: [
        _nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
        '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
        '--split-compile=0', '-o', out, source], library)


def compile_cpp(source: str, library: str) -> str:
    return _compile(lambda out: [
        'g++', '-O3', '-shared', '-fPIC', '-std=c++17', source, '-o', out],
        library)


def is_stale(source: str, library: str) -> bool:
    return (not os.path.exists(library)
            or os.path.getmtime(library) < os.path.getmtime(source))


def launch(fn, *args, device: int) -> None:
    """Call a kernel's C entry point on the current stream of CUDA device
    `device` (an index, `tensor.get_device()`).

    `args` are the entry point's arguments before its trailing stream:
    data pointers as Python ints (`tensor.data_ptr()`), which ctypes
    converts under the function's `c_void_p` argtypes, and sizes.  The
    stream is read once per call, as the raw handle that
    `torch.cuda.current_stream().cuda_stream` gives, without building a
    `Stream` object; the current device is read without
    `torch.cuda.current_device`'s initialization check (a CUDA tensor
    exists), and `torch.cuda.device` is entered only when `device` is not
    the current device.  Raises if the C function returns a CUDA error
    (it returns `cudaGetLastError()` after its launches)."""
    if device == torch._C._cuda_getDevice():   # CUDA is initialized here
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f'{fn.__name__}: CUDA launch failed with error '
                           f'{err}')
