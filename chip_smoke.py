"""Drive srtpu_torch's EDSR-baseline x4 predict and training on one CUDA
card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
1. the card: its name and power limit from nvidia-smi; the kernels are
   built from srtpu_torch/ops/csrc with nvcc (build/srtpu_torch/);
2. each forward kernel against its plain PyTorch version on the card,
   at the shapes the predict path gives it (LR 128x128 and a ragged
   67x45; batch 1, 64 channels, bf16), with the tolerance printed beside
   the error and median CUDA-event times of both;
2b. each backward kernel (and K1's forward in its saving variant)
   against its plain version at the training shapes (batch 16, LR 32x32,
   64 channels, 16 resblocks; the tail's convs at 64x64) and at a ragged
   batch 2 of 67x45, with errors, tolerances and times, and two calls
   bit-identical (the weight grads use no float atomics);
3. the predict slice: ``python -m srtpu_torch predict``'s own function
   on three synthetic LR images (128x128, 250x170 which needs bucket
   padding, 512x352), EDSR-baseline x4 (64 features, 16 resblocks,
   bf16) drawn from a fixed seed. The launch counters must show every
   forward kernel ran for every image, the PNGs must be 4x the LR size
   and byte-equal to the kernel-path SR image checked here, and the
   kernel path must match the plain path on the card;
4. the training slice: ``python -m srtpu_torch fit``'s own function on
   a synthetic ``.npy`` dataset (HR and LR/X4), EDSR-baseline x4 at full
   width and depth, batch 16, patch 128, L1, Adam at lr 1e-4, bf16, 20
   steps. The counters must show every forward and backward kernel ran
   on every step, every logged loss must be finite and the last five
   must average below the first five. Then, from one set of params and
   batches, kernel-path steps against plain-path steps (gradients and
   losses), ms per step and patches/s of both, and device time by
   kernel from torch.profiler.
The line before the last is a JSON object with each kernel's launches
(in the fit run), error and times; the last line is ``{"ok": true,
"device": {...}}``. Without CUDA (or without the repo) it exits nonzero
and prints no result.
"""

from __future__ import annotations

import copy
import json
import logging
import struct
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from srtpu_torch import cli
from srtpu_torch.data import pad_to_bucket
from srtpu_torch.losses import parse_losses
from srtpu_torch.ops import (_build, conv3x3_bwd, conv3x3_bwd_plain,
                             conv3x3_fwd, conv3x3_plain, conv_wgrad,
                             conv_wgrad_plain, trunk_bwd, trunk_bwd_plain, trunk_fwd,
                             trunk_plain, upsample_bwd, upsample_bwd_plain,
                             upsample_fwd, upsample_plain)
from srtpu_torch.optim import build_optimizer
from srtpu_torch.train import TrainState, make_train_step
from srtpu_torch.utils.logging import save_image

C, L, SCALE = 64, 16, 4
KERNEL_SIZES = ((128, 128), (67, 45))
SLICE_SIZES = ((128, 128), (250, 170), (512, 352))
SEED = 0
# per image of an x4 EDSR-baseline predict
EXPECTED_LAUNCHES = {trunk_fwd: L, conv3x3_fwd: 3, upsample_fwd: 1}
# per x4 EDSR-baseline train step: K1 one launch per block each way; K2
# the close, phase-major and phase-dense convs; K3 the first x2 stage;
# the weight-grad kernel once per K2/K3 backward and twice per K1's
STEP_LAUNCHES = {trunk_fwd: L, trunk_bwd: L, conv3x3_fwd: 3, conv3x3_bwd: 3,
                 upsample_fwd: 1, upsample_bwd: 1, conv_wgrad: 6}
TRAIN_BATCH, TRAIN_PATCH, TRAIN_STEPS = 16, 128, 20
# Kernel and plain version round at the same points; they differ only in
# the order of the f32 sums, so a result next to a bf16 rounding boundary
# can come out one step apart. K2/K3: one step at the largest magnitude.
# K1 chains 16 blocks whose skips carry such a step on: four steps.
TOL_STEPS = {'K1': 4, 'K2': 1, 'K3': 1}
# Backward: dx as the forward (K1's chain: four steps over 16 blocks);
# dW / db sum the same bf16 products in f32 in another order, 1e-4 of
# the largest magnitude; K1's weight grads read its bf16 dh1 chain,
# where a value may sit one step apart: one step.
BWD_DX_STEPS = {'K1': 4, 'K2': 1, 'K3': 1}
BWD_DW_STEPS = {'K1': 1, 'K2': None, 'K3': None}
# Train step, kernel path vs plain path from the same params and batch:
# every gradient within 2^-6 of its largest magnitude (the paths' bf16
# activations may sit a step apart through 16 blocks, and the backward
# carries that on); losses over five steps within 2^-10 relative.
STEP_GRAD_TOL, STEP_LOSS_TOL = 2.0 ** -6, 2.0 ** -10
# SR image in [0, 1], kernel path vs plain path: every K1 difference
# passes through the tail's convs (gain < 1 at this init).
SLICE_MAX_TOL, SLICE_MEAN_TOL = 2.0 ** -5, 2.0 ** -9


def need(cond, msg: str) -> None:
    """Fail the run (an ``assert`` would vanish under ``python -O``)."""
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def median_ms(fn, launches: int = 20, windows: int = 5) -> float:
    """Median over ``windows`` of the CUDA-event time of ``launches``
    back-to-back calls of ``fn``, per call. With many calls in a window
    the host runs ahead and the window measures the device; with one
    call it measures the latency a caller sees, host enqueue included.
    L2 stays warm, as on the predict path, where each kernel reads what
    the previous one just wrote."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def card() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is false')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    # The plain references run f32 convs; cuDNN would take them in TF32
    # (10-bit mantissa) by default. Full f32 for every reference here.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    so = _build.build()
    print(f'kernels built in {time.perf_counter() - t0:.2f} s: {so.name}')
    for line in so.with_suffix('.log').read_text().splitlines():
        if 'registers' in line or 'spill' in line or 'entry function' in line:
            print('  ' + line.strip())
    _build.library()
    return torch.device('cuda', 0), smi


def _uniform(gen, shape, bound, device, dtype):
    t = torch.empty(shape).uniform_(-bound, bound, generator=gen)
    return t.to(device, dtype)


def kernel_cases(h: int, w: int, device) -> list[tuple]:
    """(kernel id, label, wrapper, plain, args) at the shapes predict gives
    each kernel for an h x w LR image."""
    gen = torch.Generator().manual_seed(h * 1000 + w)
    bf = torch.bfloat16

    def act(*shape):
        return _uniform(gen, shape, 1.0, device, bf)

    def conv(cin, cout, lead=()):
        bound = 1.0 / (9 * cin) ** 0.5
        return (_uniform(gen, (*lead, 3, 3, cin, cout), bound, device, bf),
                _uniform(gen, (*lead, cout), bound, device, torch.float32))

    w1, b1 = conv(C, C, (L,))
    w2, b2 = conv(C, C, (L,))
    return [
        ('K1', f'trunk L={L} {h}x{w}', trunk_fwd, trunk_plain,
         (act(1, h, w, C), w1, b1, w2, b2, 1.0)),
        ('K2', f'close 64->64 {h}x{w}', conv3x3_fwd, conv3x3_plain,
         (act(1, h, w, C), *conv(C, C))),
        ('K3', f'upsample r=2 {h}x{w}', upsample_fwd, upsample_plain,
         (act(1, h, w, C), *conv(C, 4 * C), 2)),
        ('K2', f'phase-major 64->256 {2 * h}x{2 * w}', conv3x3_fwd,
         conv3x3_plain, (act(1, 2 * h, 2 * w, C), *conv(C, 4 * C))),
        ('K2', f'phase-dense 256->16 {2 * h}x{2 * w}', conv3x3_fwd,
         conv3x3_plain, (act(1, 2 * h, 2 * w, 4 * C), *conv(4 * C, 16))),
    ]


def check_kernels(device) -> dict:
    """Phase 2. Returns per kernel id: max error over all shapes, and
    kernel / plain ms summed over its uses at the first (aligned) size."""
    stats = {k: {'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0}
             for k in TOL_STEPS}
    for i, (h, w) in enumerate(KERNEL_SIZES):
        for kid, label, fn, plain, args in kernel_cases(h, w, device):
            got = fn(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            need(got.shape == ref.shape and got.dtype == ref.dtype, label)
            err = (got.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            tol = TOL_STEPS[kid] * 2.0 ** -7 * top
            extra = ''
            if kid == 'K1':
                # both against the trunk in f32 with no rounding at all
                exact = trunk_plain(*(a.float() if torch.is_tensor(a) else a
                                      for a in args))
                e_k = (got.float() - exact).abs().max().item()
                e_p = (ref.float() - exact).abs().max().item()
                extra = f' vs-f32: kernel {e_k:.4g} plain {e_p:.4g}'
                need(e_k <= 2 * e_p, f'{label}: kernel drifts from f32')
            ms = median_ms(lambda: fn(*args))
            plain_ms = median_ms(lambda: plain(*args))
            print(f'{kid} {label}: max_abs {err:.4g} rel {err / top:.3g} '
                  f'tol {tol:.4g}{extra} | kernel {ms:.4f} ms plain '
                  f'{plain_ms:.4f} ms')
            need(np.isfinite(err) and err <= tol, f'{label}: {err} > {tol}')
            s = stats[kid]
            s['max_abs_err'] = max(s['max_abs_err'], err)
            if i == 0:
                s['ms'] += ms
                s['plain_ms'] += plain_ms
    return stats


def _err(got, ref, steps) -> tuple[float, float, float]:
    """(max |got - ref|, its tolerance, |ref|'s largest magnitude):
    ``steps`` bf16 steps of the largest magnitude, or 1e-4 of it."""
    need(got.shape == ref.shape and got.dtype == ref.dtype,
         f'{tuple(got.shape)} {got.dtype} vs {tuple(ref.shape)} {ref.dtype}')
    top = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    return err, (steps * 2.0 ** -7 if steps else 1e-4) * top, top


def bwd_cases(bsz: int, h: int, w: int, device) -> list[tuple]:
    """(kernel id, label, wrapper, plain, args) at the shapes a train
    step gives each backward for a batch of h x w LR patches."""
    gen = torch.Generator().manual_seed(bsz * 10000 + h * 100 + w)
    bf = torch.bfloat16

    def act(*shape):
        return _uniform(gen, shape, 1.0, device, bf)

    def weight(cin, cout, lead=()):
        bound = 1.0 / (9 * cin) ** 0.5
        return _uniform(gen, (*lead, 3, 3, cin, cout), bound, device, bf)

    w1, w2 = weight(C, C, (L,)), weight(C, C, (L,))
    b1 = _uniform(gen, (L, C), 1.0 / (9 * C) ** 0.5, device, torch.float32)
    b2 = _uniform(gen, (L, C), 1.0 / (9 * C) ** 0.5, device, torch.float32)
    _, xs, h1s = trunk_fwd(act(bsz, h, w, C), w1, b1, w2, b2, 1.0,
                           save=True)
    h2, w2_ = 2 * h, 2 * w
    return [
        ('K1b', f'trunk bwd L={L} {bsz}x{h}x{w}', trunk_bwd, trunk_bwd_plain,
         (xs, h1s, act(bsz, h, w, C), w1, w2, 1.0)),
        ('K2b', f'close bwd 64->64 {bsz}x{h}x{w}', conv3x3_bwd,
         conv3x3_bwd_plain, (act(bsz, h, w, C), weight(C, C),
                             act(bsz, h, w, C))),
        ('K3b', f'upsample bwd r=2 {bsz}x{h}x{w}', upsample_bwd,
         upsample_bwd_plain, (act(bsz, h, w, C), weight(C, 4 * C),
                              act(bsz, h2, w2_, C), 2)),
        ('K2b', f'phase-major bwd 64->256 {bsz}x{h2}x{w2_}', conv3x3_bwd,
         conv3x3_bwd_plain, (act(bsz, h2, w2_, C), weight(C, 4 * C),
                             act(bsz, h2, w2_, 4 * C))),
        ('K2b', f'phase-dense bwd 256->16 {bsz}x{h2}x{w2_}', conv3x3_bwd,
         conv3x3_bwd_plain, (act(bsz, h2, w2_, 4 * C), weight(4 * C, 16),
                             act(bsz, h2, w2_, 16))),
        ('W', f'weight grads of the trunk L={L} {bsz}x{h}x{w}', conv_wgrad,
         conv_wgrad_plain, (xs, h1s)),
    ]


def check_bwd_kernels(device) -> dict:
    """Phase 2b. Returns per kernel id: max dx error (the weight-grad
    kernel: max dW error) over all shapes, and kernel / plain ms summed
    over its uses at the training shapes."""
    stats = {k: {'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0}
             for k in ('K1s', 'K1b', 'K2b', 'K3b', 'W')}
    for i, (bsz, h, w) in enumerate(((TRAIN_BATCH, TRAIN_PATCH // SCALE,
                                      TRAIN_PATCH // SCALE), (2, 67, 45))):
        # K1's forward in its saving variant: output, block inputs, h1
        gen = torch.Generator().manual_seed(h * w)
        args = (_uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16),
                *(_uniform(gen, shape, 1.0 / 24, device, dt) for shape, dt in
                  (((L, 3, 3, C, C), torch.bfloat16), ((L, C), torch.float32),
                   ((L, 3, 3, C, C), torch.bfloat16), ((L, C), torch.float32))),
                1.0)
        got = trunk_fwd(*args, save=True)
        ref = trunk_plain(*args, save=True)
        for what, g_t, r_t in zip(('out', 'xs', 'h1s'), got, ref):
            err, tol, _ = _err(g_t, r_t, TOL_STEPS['K1'])
            print(f'K1s trunk fwd, saving {what} L={L} {bsz}x{h}x{w}: '
                  f'max_abs {err:.4g} tol {tol:.4g}')
            need(err <= tol, f'K1 saving variant {what}: {err} > {tol}')
            stats['K1s']['max_abs_err'] = max(stats['K1s']['max_abs_err'],
                                              err)
        if i == 0:
            st = stats['K1s']
            st['ms'] = median_ms(lambda: trunk_fwd(*args, save=True))
            st['plain_ms'] = median_ms(lambda: trunk_plain(*args, save=True))
            print(f'K1s trunk fwd, saving, L={L} {bsz}x{h}x{w}: kernel '
                  f'{st["ms"]:.4f} ms plain {st["plain_ms"]:.4f} ms')
        for kid, label, fn, plain, args in bwd_cases(bsz, h, w, device):
            got = fn(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            again = fn(*args)
            need(all(torch.equal(a, b) for a, b in zip(got, again)),
                 f'{label}: two calls differ')
            kk = kid.rstrip('b')
            if kid == 'W':
                errs = [_err(g_t, r_t, None) for g_t, r_t in zip(got, ref)]
            else:
                errs = [_err(got[0], ref[0], BWD_DX_STEPS[kk])] + [
                    _err(g_t, r_t, BWD_DW_STEPS[kk])
                    for g_t, r_t in zip(got[1:], ref[1:])]
            ms = median_ms(lambda: fn(*args))
            plain_ms = median_ms(lambda: plain(*args))
            print(f'{kid} {label}: ' + ', '.join(
                f'max_abs {e:.4g} tol {t:.4g} (|ref| {top:.4g})'
                for e, t, top in errs) + f'; deterministic | kernel '
                f'{ms:.4f} ms plain {plain_ms:.4f} ms')
            for e, t, _ in errs:
                need(np.isfinite(e) and e <= t, f'{label}: {e} > {t}')
            st = stats[kid]
            st['max_abs_err'] = max(st['max_abs_err'], errs[0][0])
            if i == 0:
                st['ms'] += ms
                st['plain_ms'] += plain_ms
    return stats


def png_size(path: Path) -> tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk."""
    head = path.read_bytes()[:24]
    need(head[:8] == b'\x89PNG\r\n\x1a\n' and head[12:16] == b'IHDR',
         f'{path} is not a PNG')
    w, h = struct.unpack('>II', head[16:24])
    return h, w


def run_slice(device, smi: str) -> dict:
    """Phase 3. Returns the launch counts of the main-path run."""
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory(prefix='srtpu_smoke_') as tmp:
        demo = Path(tmp) / 'datasets' / 'Demo'
        demo.mkdir(parents=True)
        images = {}
        for h, w in SLICE_SIZES:
            lo = rng.random((h // 8 + 1, w // 8 + 1, 3))
            img = np.kron(lo, np.ones((8, 8, 1)))[:h, :w] * 0.8 \
                + rng.random((h, w, 3)) * 0.2
            name = f'img{h}x{w}'
            images[name] = img.astype(np.float32)
            np.save(demo / f'{name}.npy', images[name])
        argv = ['predict', '--model', 'EDSR', '--scale_factor', str(SCALE),
                '--n_feats', str(C), '--n_resblocks', str(L),
                '--datasets_dir', str(Path(tmp) / 'datasets'),
                '--predict_datasets', 'Demo', '--precision', 'bf16',
                '--device', 'cuda', '--seed', str(SEED)]
        warm = argv + ['--default_root_dir', str(Path(tmp) / 'warm')]
        need(cli.main(warm) == 0, 'warm-up predict')   # cuDNN plans, allocator
        out = Path(tmp) / 'out'
        for k in EXPECTED_LAUNCHES:
            k.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv + ['--default_root_dir', str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: k.launches for k in EXPECTED_LAUNCHES}
        need(rc == 0, f'predict returned {rc}')
        for k, per_image in EXPECTED_LAUNCHES.items():
            need(counts[k] == per_image * len(images),
                 f'{k.__name__}: {counts[k]} launches, expected '
                 f'{per_image} x {len(images)}')
        for name, img in images.items():
            size = png_size(out / 'Demo' / f'{name}.png')
            need(size == (SCALE * img.shape[0], SCALE * img.shape[1]),
                 f'{name}.png is {size}')
        mpix = sum(SCALE * SCALE * img.shape[0] * img.shape[1]
                   for img in images.values()) / 1e6
        print(f'predict CLI (incl. PNG encode + write): {len(images)} images '
              f'in {wall:.3f} s = {len(images) / wall:.3f} images/s, '
              f'{mpix / wall:.3f} MPix/s  [{smi}]')

        model = cli.build_model(cli.build_parser().parse_args(argv), device)
        for name, img in images.items():
            lr = torch.from_numpy(pad_to_bucket(img, 32)[0][None]).to(device)
            h, w = SCALE * img.shape[0], SCALE * img.shape[1]
            with torch.inference_mode():
                sr_k = model(lr).float().clamp(0, 1)[0, :h, :w]
                sr_p = model(lr, plain=True).float().clamp(0, 1)[0, :h, :w]
                ms = median_ms(lambda: model(lr), launches=1)
                plain_ms = median_ms(lambda: model(lr, plain=True),
                                     launches=1)
            need(sr_k.shape == (h, w, 3) and bool(torch.isfinite(sr_k).all()),
                 f'{name}: SR shape {tuple(sr_k.shape)} or non-finite')
            diff = (sr_k - sr_p).abs()
            err, mean = diff.max().item(), diff.mean().item()
            print(f'slice {name} (LR {tuple(lr.shape[1:3])}): '
                  f'max_abs {err:.4g}'
                  f' (tol {SLICE_MAX_TOL:.4g}) mean_abs {mean:.3g} (tol '
                  f'{SLICE_MEAN_TOL:.3g}) | forward kernels {ms:.3f} ms = '
                  f'{1e3 / ms:.2f} images/s, {h * w / ms / 1e3:.2f} MPix/s; '
                  f'plain {plain_ms:.3f} ms  [{smi}]')
            need(err <= SLICE_MAX_TOL and mean <= SLICE_MEAN_TOL,
                 f'{name}: kernel path vs plain path')
            # the CLI's PNG is this checked SR image, saved the same way
            check = Path(tmp) / 'check.png'
            save_image(sr_k.cpu().numpy(), check)
            need(check.read_bytes() ==
                 (out / 'Demo' / f'{name}.png').read_bytes(),
                 f'{name}.png differs from the checked kernel-path SR')
    return counts


class _LossLog(logging.Handler):
    """Collects the loss of each ``epoch %d/%d  loss %.4f ...`` record."""

    def __init__(self):
        super().__init__()
        self.losses: list[float] = []

    def emit(self, record):
        if record.msg.startswith('epoch '):
            self.losses.append(float(record.args[2]))


def _profile_steps(step, state, lr, hr, step_ms: float, smi: str) -> None:
    """Device time by kernel over three train steps (torch.profiler), and
    its share of ``step_ms``, the step time measured without the
    profiler (whose own host cost inflates the traced wall time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, lr, hr)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 3
    groups = {'K1 fwd': 0.0, 'K1 bwd dx chain': 0.0, 'K2 fwd + bwd dx': 0.0,
              'K3 fwd': 0.0, 'K3 bwd dx': 0.0, 'weight grads': 0.0,
              'other (cuDNN head, Adam, casts, copies)': 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, 'self_device_time_total', None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key
        if 'resblock_bwd_kernel' in name:
            key = 'K1 bwd dx chain'
        elif 'resblock_kernel' in name:
            key = 'K1 fwd'
        elif 'wgrad' in name:
            key = 'weight grads'
        elif 'conv3x3_kernel<64, 64, 7, 16, true' in name:
            key = 'K3 fwd'
        elif 'conv3x3_kernel<256, 16, 7, 16, false, true' in name:
            key = 'K3 bwd dx'
        elif 'conv3x3_kernel' in name:
            key = 'K2 fwd + bwd dx'
        else:
            key = 'other (cuDNN head, Adam, casts, copies)'
        groups[key] += us / 1e3 / 3
    device = sum(groups.values())
    if device == 0.0:
        print('profiler: no device time recorded')
        return
    print(f'train step device time by kernel (torch.profiler, 3 steps): '
          f'device {device:.3f} ms/step = {device / step_ms:.3f} of the '
          f'{step_ms:.3f} ms step (traced wall {wall:.3f} ms/step)  [{smi}]')
    for key, ms in groups.items():
        print(f'  {key}: {ms:.3f} ms ({ms / device:.3f})')


def run_train(device, smi: str) -> dict:
    """Phase 4. Returns the launch counts of the fit run."""
    rng = np.random.default_rng(SEED)
    hr_size = 3 * TRAIN_PATCH // 2
    with tempfile.TemporaryDirectory(prefix='srtpu_smoke_fit_') as tmp:
        data = Path(tmp) / 'datasets'
        hr_dir, lr_dir = data / 'Train' / 'HR', data / 'Train' / 'LR' / 'X4'
        hr_dir.mkdir(parents=True)
        lr_dir.mkdir(parents=True)
        for i in range(TRAIN_BATCH):     # one step per epoch
            lo = rng.random((hr_size // 8, hr_size // 8, 3))
            hr = (np.kron(lo, np.ones((8, 8, 1))) * 0.8
                  + rng.random((hr_size, hr_size, 3)) * 0.2).astype(np.float32)
            np.save(hr_dir / f'{i:02d}.npy', hr)
            lr = hr.reshape(hr_size // SCALE, SCALE, hr_size // SCALE, SCALE,
                            3).mean((1, 3))
            np.save(lr_dir / f'{i:02d}.npy', lr.astype(np.float32))
        argv = ['fit', '--model', 'EDSR', '--scale_factor', str(SCALE),
                '--n_feats', str(C), '--n_resblocks', str(L),
                '--datasets_dir', str(data), '--train_datasets', 'Train',
                '--batch_size', str(TRAIN_BATCH), '--patch_size',
                str(TRAIN_PATCH), '--losses', 'l1', '--optimizer', 'ADAM',
                '--optimizer_params', 'lr=1e-4', '--max_epochs',
                str(TRAIN_STEPS), '--precision', 'bf16', '--device', 'cuda',
                '--seed', str(SEED), '--default_root_dir',
                str(Path(tmp) / 'run')]
        log = _LossLog()
        logging.getLogger('srtpu_torch.train.loop').addHandler(log)
        for k in STEP_LAUNCHES:
            k.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: k.launches for k in STEP_LAUNCHES}
        logging.getLogger('srtpu_torch.train.loop').removeHandler(log)
        need(rc == 0, f'fit returned {rc}')
        for k, per_step in STEP_LAUNCHES.items():
            need(counts[k] == per_step * TRAIN_STEPS,
                 f'{k.__name__}: {counts[k]} launches in fit, expected '
                 f'{per_step} x {TRAIN_STEPS}')
        losses = log.losses
        need(len(losses) == TRAIN_STEPS and all(map(np.isfinite, losses)),
             f'fit losses {losses}')
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f'fit CLI: {TRAIN_STEPS} steps in {wall:.3f} s (incl. model '
              f'init, .npy reads, batching, logs); losses '
              + ' '.join(f'{v:.4f}' for v in losses)
              + f'; mean first 5 {first:.5f} last 5 {last:.5f}  [{smi}]')
        need(last < first, 'the fit loss did not fall')
        need((Path(tmp) / 'run' / 'final_weights.pt').is_file(),
             'fit wrote no final_weights.pt')

        # kernel path vs plain path from the same params and batches
        model = cli.build_model(cli.build_parser().parse_args(argv), device)
        from srtpu_torch.data import SRData
        dm = SRData(datasets_dir=str(data), train_datasets=['Train'],
                    batch_size=TRAIN_BATCH, patch_size=TRAIN_PATCH,
                    scale_factor=SCALE, seed=SEED)
        dm.setup('fit')
        loader = dm.train_loader()
        batches = []
        for epoch in range(5):
            loader.set_epoch(epoch)
            b = next(iter(loader))
            batches.append((torch.from_numpy(b.lr).to(device),
                            torch.from_numpy(b.hr).to(device)))
        paths = {}
        for plain in (False, True):
            m = copy.deepcopy(model)
            paths[plain] = (make_train_step(parse_losses('l1'), plain=plain),
                            TrainState(m, build_optimizer(
                                'ADAM', ['lr=1e-4'], m.parameters())))
        step_losses = {False: [], True: []}
        for j, (lr, hr) in enumerate(batches):
            for plain, (step, state) in paths.items():
                step_losses[plain].append(float(step(state, lr, hr)['loss']))
            if j == 0:      # gradients from identical params and batch
                worst, worst_name = 0.0, ''
                for (name, pk), pp in zip(
                        paths[False][1].model.named_parameters(),
                        paths[True][1].model.parameters()):
                    need(pk.grad.dtype == torch.float32, f'{name} grad dtype')
                    rel = ((pk.grad - pp.grad).abs().max()
                           / pp.grad.abs().max()).item()
                    if rel > worst:
                        worst, worst_name = rel, name
                print(f'train step, kernel vs plain path: worst gradient '
                      f'{worst_name} max_abs/max|ref| {worst:.4g} (tol '
                      f'{STEP_GRAD_TOL:.4g})')
                need(worst <= STEP_GRAD_TOL, f'{worst_name} gradient')
        rels = [abs(a - b) / b for a, b in zip(step_losses[False],
                                               step_losses[True])]
        print('train losses kernel / plain: ' + ' '.join(
            f'{a:.5f}/{b:.5f}' for a, b in zip(step_losses[False],
                                               step_losses[True]))
            + f'; max rel {max(rels):.4g} (tol {STEP_LOSS_TOL:.4g})')
        need(max(rels) <= STEP_LOSS_TOL, 'kernel vs plain path losses')
        lr, hr = batches[0]
        times = {}
        for plain, (step, state) in paths.items():
            times[plain] = median_ms(lambda: step(state, lr, hr),
                                     launches=5, windows=3)
        for plain, label in ((False, 'kernel'), (True, 'plain')):
            print(f'train step ({label} path): {times[plain]:.3f} ms/step = '
                  f'{TRAIN_BATCH * 1e3 / times[plain]:.2f} patches/s '
                  f'(batch {TRAIN_BATCH}, LR {TRAIN_PATCH // SCALE}x'
                  f'{TRAIN_PATCH // SCALE} -> HR {TRAIN_PATCH}x{TRAIN_PATCH}, '
                  f'L1 + Adam)  [{smi}]')
        _profile_steps(paths[False][0], paths[False][1], lr, hr,
                       times[False], smi)
    return counts


def main() -> None:
    device, smi = card()
    stats = check_kernels(device)
    stats.update(check_bwd_kernels(device))
    predict_counts = run_slice(device, smi)
    fit_counts = run_train(device, smi)
    rep = 'srtpu/ops/cs_conv.py:'
    meta = [('K1', 'K1 trunk_fwd (fused resblock)', trunk_fwd, 'trunk.cu',
             rep + '1496'),
            ('K2', 'K2 conv3x3_fwd', conv3x3_fwd, 'conv.cu', rep + '538'),
            ('K3', 'K3 upsample_fwd', upsample_fwd, 'upsample.cu',
             rep + '952'),
            ('K1b', 'K1 trunk_bwd (resblock dx chain)', trunk_bwd, 'trunk.cu',
             rep + '1527'),
            ('K2b', 'K2 conv3x3_bwd (dx; with its weight grads)', conv3x3_bwd,
             'conv.cu', rep + '581'),
            ('K3b', 'K3 upsample_bwd (dx, de-interleave in the load; with '
             'its weight grads)', upsample_bwd, 'upsample.cu', rep + '975'),
            ('W', 'conv_wgrad (dW, db of the K1/K2/K3 backward passes)',
             conv_wgrad, 'wgrad.cu', rep + '452')]
    print(json.dumps({'kernels': [
        {'name': name, 'route': 'cuda', 'source': 'srtpu_torch/ops/csrc/' + src,
         'replaces': r, 'launches': fit_counts[fn],
         'predict_launches': predict_counts.get(fn, 0), **stats[kid]}
        for kid, name, fn, src, r in meta]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
