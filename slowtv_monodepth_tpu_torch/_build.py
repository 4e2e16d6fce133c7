"""Build the port's CUDA kernels with nvcc at first use and load them.

Every `csrc/*.cu` file compiles in its own nvcc process, all started
together, and the objects link into ONE shared library with a plain C
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
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
# C entry point -> argument types (see the signatures in csrc/*.cu).
SIGNATURES = {
    'slowtv_dwconv_fwd_f32': [_PTR] * 4 + [_INT] * 6 + [_PTR],
    'slowtv_dwconv_dw_f32': [_PTR] * 4 + [_INT] * 9 + [_PTR],
    'slowtv_convnext_block_fwd_f32': [_PTR] * 12 + [_INT] * 9 + [_PTR],
    'slowtv_convnext_block_bwd_f32': [_PTR] * 21 + [_INT] * 10 + [_PTR],
    'slowtv_decoder_stage_fwd_f32': [_PTR] * 10 + [_INT] * 15 + [_PTR],
    'slowtv_decoder_stage_bwd_f32': [_PTR] * 17 + [_INT] * 7 + [_PTR],
    'slowtv_warp_bilinear_f32': [_PTR] * 6 + [_INT] * 7 + [_PTR],
    'slowtv_warp_bilinear_packed_bf16': [_PTR] * 6 + [_INT] * 7 + [_PTR],
    'slowtv_photo_fwd_f32': [_PTR] * 3 + [_INT] * 4 + [_FLOAT] * 2 + [_INT, _PTR],
    'slowtv_photo_bwd_f32': [_PTR] * 5 + [_INT] * 4 + [_FLOAT] * 2 + [_INT] * 2 + [_PTR],
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
    nvcc, tag = _nvcc(), f'{digest.hexdigest()[:16]}.{os.getpid()}'
    tmp = path.with_suffix(f'.{os.getpid()}.tmp')
    # One nvcc per source, all started together, then one link.
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in _sources() if s.suffix == '.cu'):
        obj = BUILD_DIR / f'{src.stem}.{tag}.o'
        cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    steps = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    link = [nvcc, *NVCC_FLAGS[:2], '-shared', '-o', str(tmp), *map(str, objs)]
    if all(rc == 0 for *_, rc in steps):
        proc = subprocess.run(link, capture_output=True, text=True)
        steps.append((link, proc.stdout + proc.stderr, proc.returncode))
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = ''.join(out for _, out, _ in steps)
    for cmd, out, rc in steps:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f'nvcc failed (exit {rc}):\n{" ".join(cmd)}\n{out}')
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
    lib.slowtv_decoder_stage_bwd_scratch_floats.argtypes = [_INT] * 5
    lib.slowtv_decoder_stage_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.slowtv_convnext_block_fwd_cluster_blocks.argtypes = [_INT] * 2
    lib.slowtv_convnext_block_fwd_cluster_blocks.restype = ctypes.c_int
    lib.slowtv_convnext_block_fwd_scratch_floats.argtypes = [_INT] * 4
    lib.slowtv_convnext_block_fwd_scratch_floats.restype = ctypes.c_longlong
    lib.slowtv_convnext_block_bwd_scratch_floats.argtypes = [_INT] * 7
    lib.slowtv_convnext_block_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.slowtv_photo_bwd_smem_bytes.argtypes = [_INT] * 2
    lib.slowtv_photo_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.slowtv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.slowtv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err:
        text = load().slowtv_cuda_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({text}) at launch')
