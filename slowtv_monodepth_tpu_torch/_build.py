"""Build the port's CUDA kernels with nvcc at first use and load them.

Every `csrc/*.cu` file compiles into ONE shared library with a plain C
interface (no PyTorch headers, so nvcc takes seconds), which `load` opens
with `ctypes`. Each C entry point takes raw device pointers, the device
index and the stream, launches on that stream and returns `cudaGetLastError()`;
`check` turns a non-zero code into an exception.

The library lands in `build/torch_kernels/` at the repo root, named by a
hash of the sources and the nvcc command, so editing a source builds anew
and an unchanged tree reuses the library across processes. The build is
for Hopper only (`sm_90a`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ['Build', 'build', 'load', 'check', 'BUILD_DIR']

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[1] / 'build' / 'torch_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# C entry point -> argument types (see the signatures in csrc/*.cu).
SIGNATURES = {
    'slowtv_dwconv_fwd_f32': [_PTR] * 4 + [_INT] * 6 + [_PTR],
    'slowtv_decoder_stage_fwd_f32': [_PTR] * 10 + [_INT] * 6 + [_PTR],
}


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library already existed
    log: str        # nvcc's output: ptxas registers / shared memory / spills


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    for cand in ((Path(home) / 'bin' / 'nvcc') if home else None,
                 shutil.which('nvcc'), Path('/usr/local/cuda/bin/nvcc')):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH '
                       '(the CUDA kernels build only where the CUDA toolkit is).')


def _sources() -> list[Path]:
    return sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))


@functools.cache
def build() -> Build:
    """Compile `csrc/*.cu` into one library unless this exact build exists."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    path = BUILD_DIR / f'libslowtv_kernels_{digest.hexdigest()[:16]}.so'
    if path.is_file():
        return Build(path, 0.0, '')

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
           *[str(s) for s in _sources() if s.suffix == '.cu']]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed (exit {proc.returncode}):\n'
                           f'{" ".join(cmd)}\n{log}')
    os.replace(tmp, path)  # Atomic: a concurrent build sees all or nothing.
    path.with_suffix('.log').write_text(log)
    return Build(path, seconds, log)


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, open the library and declare its C signatures."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.slowtv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.slowtv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err:
        text = load().slowtv_cuda_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({text}) at launch')
