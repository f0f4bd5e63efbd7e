"""The training loader's native core (srtpu/data/native.py): the port's
own ``csrc/patchops.cc``, built with g++ at first use and bound through
ctypes.

The library is built into ``build/srtpu_torch/`` beside the package
(git-ignored, where ``ops/_build.py`` puts the CUDA kernels) with
``g++ -O3 -march=native -shared -fPIC -pthread``. Its name carries a hash
of the source, the flags and the host's CPU, so an edited source or
another machine's instruction set rebuilds. :func:`build` raises with
g++'s output when the build fails; :func:`available` logs that at
WARNING and answers False, and the loader then takes its numpy core,
which gives the same bits (``TrainLoader.core`` says which runs).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / 'csrc' / 'patchops.cc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'srtpu_torch'
FLAGS = ['-O3', '-march=native', '-shared', '-fPIC', '-pthread']

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)
_VPP = ctypes.POINTER(ctypes.c_void_p)
_I = ctypes.c_int
SIGNATURES = {
    'extract_patch_pair': [_F32P, _I, _I, _F32P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _F32P, _F32P],
    'extract_patch_batch': [_VPP, _IP, _VPP, _IP, _I, _I, _I, _I, _IP, _IP,
                            _IP, _IP, _IP, _F32P, _F32P, _I],
    'bicubic_downscale_u8': [_U8P, _I, _I, _I, _I, _I, _U8P],
    'bicubic_downscale_f32': [_F32P, _I, _I, _I, _I, _I, _F32P],
}

_lib: ctypes.CDLL | None = None
_failed: str | None = None      # the first build's error, once it failed
_lock = threading.Lock()


def _cpu_tag() -> str:
    """The host's CPU flags (``-march=native`` compiles for them)."""
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith(('flags', 'Features')):
                    return line
    except OSError:
        pass
    return platform.machine() + platform.processor()


def library_path() -> Path:
    h = hashlib.sha256(' '.join(FLAGS).encode())
    h.update(_cpu_tag().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f'libpatchops_{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile ``csrc/patchops.cc`` unless the library for this source,
    these flags and this CPU exists; return its path. Raises
    RuntimeError with g++'s output when g++ fails or is missing."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
    cmd = ['g++', *FLAGS, str(SOURCE), '-o', str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f'g++ could not build {SOURCE}: {e}') from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed ({proc.returncode}): {" ".join(cmd)}'
                           f'\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, so)     # atomic: a concurrent reader sees all or none
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises RuntimeError if
    the build or the load fails (and again on every later call)."""
    global _lib, _failed
    with _lock:
        if _lib is not None:
            return _lib
        if _failed is not None:
            raise RuntimeError(_failed)
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _failed = f'the native patch core is unavailable: {e}'
            raise RuntimeError(_failed) from e
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native core runs here; a failed build is logged at
    WARNING with g++'s output (once) and answers False."""
    if _lib is not None:
        return True
    warn = _failed is None
    try:
        get_lib()
        return True
    except RuntimeError as e:
        if warn:
            _logger.warning('%s; the training loader takes its numpy core',
                            e)
        return False


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _ip(a: np.ndarray):
    return a.ctypes.data_as(_IP)


def _check_f32(*arrays) -> None:
    for a in arrays:
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            raise ValueError(f'the native core takes C-contiguous float32 '
                             f'arrays, got {a.dtype} (contiguous: '
                             f'{a.flags.c_contiguous})')


def _check_crops(lr_shapes, hr_shapes, lp: int, scale: int, ys,
                 xs) -> None:
    """Every crop lies inside its images (the C++ reads without checks):
    ``lr_shapes`` / ``hr_shapes`` (n, 3), ``ys`` / ``xs`` (n,)."""
    ok = ((ys >= 0) & (xs >= 0) & (ys + lp <= lr_shapes[:, 0])
          & (xs + lp <= lr_shapes[:, 1])
          & ((ys + lp) * scale <= hr_shapes[:, 0])
          & ((xs + lp) * scale <= hr_shapes[:, 1]))
    if not ok.all():
        j = int(np.argmin(ok))
        raise ValueError(f'item {j}: a crop at LR ({ys[j]}, {xs[j]}) of {lp} '
                         f'(x{scale}) leaves LR {tuple(lr_shapes[j, :2])} or '
                         f'HR {tuple(hr_shapes[j, :2])}')


def extract_patch_pair(lr: np.ndarray, hr: np.ndarray, patch_size: int,
                       scale: int, lr_y: int, lr_x: int, rot: int,
                       hflip: bool, vflip: bool,
                       out_lr: np.ndarray, out_hr: np.ndarray) -> None:
    """One aligned crop + augment into preallocated float32 slots
    (``out_lr`` (lp, lp, C), ``out_hr`` (patch, patch, C))."""
    lib = get_lib()
    _check_f32(lr, hr, out_lr, out_hr)
    lp = patch_size // scale
    c = lr.shape[2]
    _check_crops(np.array([lr.shape]), np.array([hr.shape]), lp, scale,
                 np.array([lr_y]), np.array([lr_x]))
    if out_lr.shape != (lp, lp, c) or out_hr.shape != (patch_size,
                                                       patch_size, c):
        raise ValueError(f'slots {out_lr.shape}, {out_hr.shape} for a '
                         f'{patch_size} patch x{scale}')
    lib.extract_patch_pair(
        _fp(lr), lr.shape[0], lr.shape[1], _fp(hr), hr.shape[0], hr.shape[1],
        c, scale, lp, int(lr_y), int(lr_x), int(rot), int(hflip), int(vflip),
        _fp(out_lr), _fp(out_hr))


def extract_patch_batch(lrs, hrs, patch_size: int, scale: int,
                        ys: np.ndarray, xs: np.ndarray, rots: np.ndarray,
                        hflips: np.ndarray, vflips: np.ndarray,
                        out_lr: np.ndarray, out_hr: np.ndarray,
                        nthreads: int = 1) -> None:
    """A whole batch's crops + augments in ONE call (the item loop,
    striped over ``nthreads`` threads, lives in C++): item ``j`` into
    ``out_lr[j]`` and ``out_hr[j]``."""
    lib = get_lib()
    n = len(lrs)
    lp = patch_size // scale
    c = lrs[0].shape[2]
    _check_f32(out_lr, out_hr, *lrs, *hrs)
    if len(hrs) != n or out_lr.shape != (n, lp, lp, c) or \
            out_hr.shape != (n, patch_size, patch_size, c):
        raise ValueError(f'{n} LR, {len(hrs)} HR items into slots '
                         f'{out_lr.shape}, {out_hr.shape}')
    ys, xs, rots, hflips, vflips = params = [
        np.ascontiguousarray(a, np.int32)
        for a in (ys, xs, rots, hflips, vflips)]
    if any(p.shape != (n,) for p in params):
        raise ValueError(f'crop and augment draws for {n} items, got '
                         f'{[p.shape for p in params]}')
    lr_shapes = np.array([a.shape for a in lrs])
    hr_shapes = np.array([a.shape for a in hrs])
    if lr_shapes.shape != (n, 3) or hr_shapes.shape != (n, 3) or \
            (lr_shapes[:, 2] != c).any() or (hr_shapes[:, 2] != c).any():
        raise ValueError(f'items of {c} channels (H, W, C), got '
                         f'{lr_shapes.tolist()} and {hr_shapes.tolist()}')
    _check_crops(lr_shapes, hr_shapes, lp, scale, ys, xs)
    lptr = (ctypes.c_void_p * n)(*[a.ctypes.data for a in lrs])
    hptr = (ctypes.c_void_p * n)(*[a.ctypes.data for a in hrs])
    lr_ws = np.ascontiguousarray(lr_shapes[:, 1], np.int32)
    hr_ws = np.ascontiguousarray(hr_shapes[:, 1], np.int32)
    lib.extract_patch_batch(
        ctypes.cast(lptr, _VPP), _ip(lr_ws), ctypes.cast(hptr, _VPP),
        _ip(hr_ws), n, c, scale, lp, _ip(ys), _ip(xs), _ip(rots),
        _ip(hflips), _ip(vflips), _fp(out_lr), _fp(out_hr), int(nthreads))


def bicubic_downscale(hr: np.ndarray, scale: int) -> np.ndarray:
    """Pillow's bicubic downscale by ``scale`` (a = -0.5, antialiased,
    taps past the border dropped and the rest renormalized): uint8 in,
    uint8 out (rounded as Pillow rounds); anything else as float32."""
    lib = get_lib()
    if hr.ndim != 3:
        raise ValueError(f'an (H, W, C) image, got {hr.shape}')
    h, w, c = hr.shape
    oh, ow = h // scale, w // scale
    if hr.dtype == np.uint8:
        src = np.ascontiguousarray(hr)
        out = np.empty((oh, ow, c), np.uint8)
        lib.bicubic_downscale_u8(src.ctypes.data_as(_U8P), h, w, c, oh, ow,
                                 out.ctypes.data_as(_U8P))
        return out
    src = np.ascontiguousarray(hr, np.float32)
    out = np.empty((oh, ow, c), np.float32)
    lib.bicubic_downscale_f32(_fp(src), h, w, c, oh, ow, _fp(out))
    return out
