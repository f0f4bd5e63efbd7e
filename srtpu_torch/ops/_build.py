"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Every ``csrc/*.cu`` compiles (one nvcc per source, all started
together) and links into one shared library with a plain C interface,
at first use, into ``build/srtpu_torch/`` beside the package
(git-ignored). The library's name carries a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'srtpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: name -> argtypes (every entry point returns int)
SIGNATURES = {
    'srt_conv3x3_fwd': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    'srt_upsample_fwd': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    'srt_upsample_bwd_dx': [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    'srt_trunk_fwd': [_P] * 5 + [_F] + [_P] * 3 + [_I] * 6 + [_P],
    'srt_trunk_chain': [_P] * 4 + [_F] + [_P] * 4 + [_I] * 5 + [_P],
    'srt_conv5x5_fwd': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    'srt_conv_dx': [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    'srt_conv_wgrad': [_P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I, _I,
                       _I, _I, _F, _I, _I, _I, _I, _P],
    'srt_bn_conv_stats': [_P] * 11 + [_I] * 4 + [_P],
    'srt_bn_norm_skip': [_P] * 4 + [_L, _P],
    'srt_bn_sums': [_P] * 5 + [_L, _P],
    'srt_bn_bwd_conv': [_P] * 17 + [_I] * 4 + [_P],
    'srt_bn_trunk_fwd': [_P] * 19 + [_I] * 5 + [_P],
    'srt_bn_trunk_bwd': [_P] * 26 + [_I] * 7 + [_P],
    'srt_rcab_group_fwd': [_P] * 15 + [_I] * 7 + [_P],
    'srt_rcab_group_chain': [_P] * 19 + [_I] * 6 + [_P],
    'srt_rdn_fwd': [_P] * 7 + [_I] * 6 + [_P],
    'srt_rdb_bwd_chain': [_P] * 3 + [_I] * 2 + [_P] * 12 + [_I] * 6 + [_P],
    'srt_rdb_bwd_dw': [_P] * 4 + [_I] * 6 + [_P],
    'srt_rdn_conv': [_P, _I, _P, _I, _P, _P] + [_I] * 7 + [_P],
    'srt_wdsr_trunk_fwd': [_P] * 7 + [_F] + [_P] * 3 + [_I] * 8 + [_P],
    'srt_wdsr_trunk_bwd': [_P] * 7 + [_F] + [_P] * 16 + [_I] * 13 + [_P],
    'srt_resblock_f32_fwd': [_P] * 5 + [_F] + [_P] * 4 + [_I] * 6 + [_P],
    'srt_ca_layer_fwd': [_P] * 7 + [_I] * 5 + [_P],
    'srt_wdsr_block_fwd': [_P] * 7 + [_F] + [_P] * 2 + [_I] * 6 + [_P],
    'srt_resblock_f32_bwd': [_P] * 5 + [_F] + [_P] * 11 + [_I] * 6 + [_P],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    found = shutil.which('nvcc') or str(Path(cuda_home) / 'bin' / 'nvcc')
    if not Path(found).exists():
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit (set CUDA_HOME or put nvcc on PATH)')
    return found


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob('*.cu*')):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run(procs: list) -> str:
    """Wait for every nvcc process; raise with its output if one failed."""
    out = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}): '
                               f'{" ".join(cmd)}\n{stdout}{stderr}')
        out.append(stdout + stderr)
    return ''.join(out)


def _start(cmd: list) -> tuple:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists;
    return its path. One nvcc per source runs in parallel, then one links.
    nvcc's output (ptxas registers, shared memory, spills) is kept beside
    the library as ``.log``."""
    so = BUILD_DIR / f'libsrtpu_kernels_{_digest()}.so'
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f'.{os.getpid()}.tmp')
    nvcc = _nvcc()
    objs = [tmp.with_name(f'{tmp.name}.{src.stem}.o')
            for src in sorted(CSRC.glob('*.cu'))]
    log = _run([_start([nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)])
                for src, obj in zip(sorted(CSRC.glob('*.cu')), objs)])
    log += _run([_start([nvcc, *NVCC_FLAGS, '-shared', '-o', str(tmp),
                         *(str(o) for o in objs)])])
    for obj in objs:
        obj.unlink()
    so.with_suffix('.log').write_text(log)
    os.replace(tmp, so)     # atomic: a concurrent reader sees all or none
    return so


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err}')


def expect(t, name: str, dtype, shape, device, aligned: bool = True) -> None:
    """Raise unless ``t`` is what a kernel takes: on ``device``, of
    ``dtype`` and ``shape``, contiguous and, with ``aligned``, 16-byte
    aligned (the kernels move 16-byte vectors; small tensors read one
    value at a time pass ``aligned=False``)."""
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} is {t.dtype}, the kernel takes {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if not t.is_contiguous() or (aligned and t.data_ptr() % 16):
        raise ValueError(f'{name} must be contiguous and 16-byte aligned')


# the devices an srtpu:: operator has a version for: the card (the
# kernel) and the CPU (the plain version). A wrapper given a tensor
# elsewhere (meta, whose fake versions the operators have) calls the
# kernel's launch directly, whose checks raise; under a fake mode
# (export) a tensor reports the device it stands for.
OP_DEVICES = ('cpu', 'cuda')


def ptr(t) -> int | None:
    """A tensor's data pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def on(device):
    """torch.cuda.device(device), or nothing when it is current (entering
    it costs microseconds a launch)."""
    import torch
    return (contextlib.nullcontext()
            if device.index == torch.cuda.current_device()
            else torch.cuda.device(device))


def stream(device) -> int:
    """The raw handle of ``device``'s current stream (PyTorch's own
    lookup, without building a Stream object: it is on every launch's
    host path)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)
