"""Drive srtpu_torch's EDSR-baseline x4 predict on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
1. the card: its name and power limit from nvidia-smi; the kernels are
   built from srtpu_torch/ops/csrc with nvcc (build/srtpu_torch/);
2. each kernel against its plain PyTorch version on the card, at the
   shapes the predict path gives it (LR 128x128 and a ragged 67x45;
   batch 1, 64 channels, bf16), with the tolerance printed beside the
   error and median CUDA-event times of both;
3. the slice: ``python -m srtpu_torch predict``'s own function on three
   synthetic LR images (128x128, 250x170 which needs bucket padding,
   512x352), EDSR-baseline x4 (64 features, 16 resblocks, bf16) drawn
   from a fixed seed. The launch counters must show every kernel ran
   for every image, the PNGs must be 4x the LR size and byte-equal to
   the kernel-path SR image checked here, and the kernel path must
   match the plain path on the card.
The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA (or without the repo) it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import struct
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from srtpu_torch import cli
from srtpu_torch.data import pad_to_bucket
from srtpu_torch.ops import (_build, conv3x3_fwd, conv3x3_plain, trunk_fwd,
                             trunk_plain, upsample_fwd, upsample_plain)
from srtpu_torch.utils.logging import save_image

C, L, SCALE = 64, 16, 4
KERNEL_SIZES = ((128, 128), (67, 45))
SLICE_SIZES = ((128, 128), (250, 170), (512, 352))
SEED = 0
# per image of an x4 EDSR-baseline predict
EXPECTED_LAUNCHES = {trunk_fwd: L, conv3x3_fwd: 3, upsample_fwd: 1}
# Kernel and plain version round at the same points; they differ only in
# the order of the f32 sums, so a result next to a bf16 rounding boundary
# can come out one step apart. K2/K3: one step at the largest magnitude.
# K1 chains 16 blocks whose skips carry such a step on: four steps.
TOL_STEPS = {'K1': 4, 'K2': 1, 'K3': 1}
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


def main() -> None:
    device, smi = card()
    stats = check_kernels(device)
    counts = run_slice(device, smi)
    meta = [('K1', 'K1 trunk_fwd (fused resblock)', trunk_fwd,
             'srtpu_torch/ops/csrc/trunk.cu', 'srtpu/ops/cs_conv.py:1496'),
            ('K2', 'K2 conv3x3_fwd', conv3x3_fwd,
             'srtpu_torch/ops/csrc/conv.cu', 'srtpu/ops/cs_conv.py:538'),
            ('K3', 'K3 upsample_fwd', upsample_fwd,
             'srtpu_torch/ops/csrc/upsample.cu', 'srtpu/ops/cs_conv.py:952')]
    print(json.dumps({'kernels': [
        {'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
         'launches': counts[fn], **stats[kid]}
        for kid, name, fn, src, rep in meta]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
