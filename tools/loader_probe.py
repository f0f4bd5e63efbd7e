"""Where the training loader's producer spends its time on this host.

    python tools/loader_probe.py [--images 800] [--batches 30]

Holds ``--images`` random float32 HR images of 256x256 and their LR of
64x64 in RAM, as the train sources' RAM cache holds phase 31's set
(chip_smoke.py), and prints, each a median over ``--batches`` batches of
16 at patch 128 x4 (the first two dropped):

* a plain copy of a batch's own bytes (``np.copyto`` of its LR and HR
  patches, 3.1875 MiB) and numpy's gather of its 16 crops (slices of
  the RAM images, no augment) into pageable and, where there is a card,
  into pinned slots: the host's rate for the batch's bytes on one
  thread;
* the native core's batch call (``data.native.extract_patch_batch``)
  into pinned (where there is a card) and pageable slots, at 1, 2, 4 and
  8 threads, without rotations and with srtpu's random ones;
* the producer's parts of a batch (``TrainLoader._fetch_items``,
  ``_draw_params``, the native call) at ``num_workers`` 1 and 4;
* with a card, whether a ``fit`` leaves anything behind that slows what
  runs after it: an eager EDSR-baseline x4 train step (batch 16, batches
  on the card, host-bound) timed before any fit and after each of two
  CLI fits through the loader (chip_smoke's 20 one-step epochs on 16
  images, then 3 epochs of 4 steps on 64), and after each fit the
  Python threads alive and the CPU time the process's other threads
  (``/proc/self/task``) take over one idle second.

Host clocks (``time.perf_counter``); nothing runs on the card but the
pinned allocations and the last item. A rate is the batch's bytes read plus written (2 x
3.1875 MiB) over the median time, in GB/s, and its share of the plain
copy's rate into the same slots. Each line ends with the host's core
count and, with a card, its name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from srtpu_torch.data import TrainLoader, native  # noqa: E402
from srtpu_torch.data.sources import Source  # noqa: E402

BATCH, PATCH, SCALE = 16, 128, 4


class _RamSource(Source):
    def __init__(self, lrs, hrs):
        self._lrs, self._hrs = lrs, hrs

    def __len__(self):
        return len(self._hrs)

    def get(self, index):
        return self._lrs[index], self._hrs[index], str(index)

    def cached(self, index):
        return True


def _median_ms(times) -> float:
    return float(np.median(times[2:])) * 1e3


def _thread_ticks() -> dict:
    """CPU clock ticks (user + system) of each of this process's threads."""
    out = {}
    for tid in os.listdir('/proc/self/task'):
        try:
            stat = Path(f'/proc/self/task/{tid}/stat').read_text()
        except FileNotFoundError:
            continue
        fields = stat.rsplit(')', 1)[1].split()
        out[tid] = int(fields[11]) + int(fields[12])
    return out


def _fit_set(root: Path, n: int, size: int) -> Path:
    rng = np.random.default_rng(0)
    hr_dir, lr_dir = root / 'Train' / 'HR', root / 'Train' / 'LR' / 'X4'
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    for i in range(n):
        hr = rng.random((size, size, 3), dtype=np.float32)
        np.save(hr_dir / f'{i:02d}.npy', hr)
        np.save(lr_dir / f'{i:02d}.npy', hr.reshape(
            size // 4, 4, size // 4, 4, 3).mean((1, 3)))
    return root


def after_fit(where: str) -> None:
    """The host-bound eager step before any fit and after each of two
    CLI fits, with the threads a fit leaves (module note)."""
    import tempfile
    import threading

    from srtpu_torch import cli
    from srtpu_torch.losses import parse_losses
    from srtpu_torch.models import create_model
    from srtpu_torch.train import TrainState, make_train_step
    device = torch.device('cuda')
    gen = torch.Generator().manual_seed(0)
    net = create_model('EDSR', scale_factor=SCALE, dtype=torch.bfloat16,
                       device=device, n_feats=64, n_resblocks=16,
                       generator=gen)
    comp = parse_losses('l1')
    state = TrainState.create(net, comp, 'ADAM', ['lr=1e-4'])
    step = make_train_step(comp)
    lp = PATCH // SCALE
    lr = torch.rand(BATCH, lp, lp, 3, generator=gen).to(device)
    hr = torch.rand(BATCH, PATCH, PATCH, 3, generator=gen).to(device)

    def step_ms() -> float:
        for _ in range(3):
            step(state, lr, hr)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                step(state, lr, hr)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 10)
        return float(np.median(times)) * 1e3

    print(f'eager EDSR x4 step before any fit: {step_ms():.3f} ms '
          f'[{where}]', flush=True)
    with tempfile.TemporaryDirectory(prefix='loader_probe_') as tmp:
        for i, (n, size, epochs) in enumerate(((16, 192, 20),
                                               (64, 256, 3))):
            data = _fit_set(Path(tmp) / f'data{i}', n, size)
            rc = cli.main([
                'fit', '--model', 'EDSR', '--scale_factor', str(SCALE),
                '--n_feats', '64', '--n_resblocks', '16', '--datasets_dir',
                str(data), '--train_datasets', 'Train', '--batch_size',
                str(BATCH), '--patch_size', str(PATCH), '--losses', 'l1',
                '--optimizer', 'ADAM', '--optimizer_params', 'lr=1e-4',
                '--max_epochs', str(epochs), '--precision', 'bf16',
                '--device', 'cuda', '--seed', '0', '--default_root_dir',
                str(Path(tmp) / f'run{i}')])
            if rc != 0:
                raise SystemExit(f'fit returned {rc}')
            torch.cuda.synchronize()
            main_tid = str(threading.get_native_id())
            before = _thread_ticks()
            time.sleep(1.0)
            after = _thread_ticks()
            busy = sum(v - before.get(t, 0) for t, v in after.items()
                       if t != main_tid)
            alive = sorted(t.name for t in threading.enumerate()
                           if t is not threading.main_thread())
            print(f'after fit {i + 1} ({epochs} epochs of {n} images): '
                  f'Python threads alive besides the main one {alive}; '
                  f'{len(after)} OS threads, the others took {busy} clock '
                  f'ticks ({os.sysconf("SC_CLK_TCK")} a second) over one '
                  f'idle second; eager EDSR x4 step {step_ms():.3f} ms '
                  f'[{where}]', flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--images', type=int, default=800)
    ap.add_argument('--batches', type=int, default=30)
    args = ap.parse_args()
    card = torch.cuda.is_available()
    where = f'{os.cpu_count()} cores'
    if card:
        where += ', ' + subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip()
    if not native.available():
        raise SystemExit('the native core did not build')
    rng = np.random.default_rng(0)
    hrs = [rng.random((256, 256, 3), dtype=np.float32)
           for _ in range(args.images)]
    lrs = [rng.random((64, 64, 3), dtype=np.float32)
           for _ in range(args.images)]

    lp = PATCH // SCALE
    shapes = ((BATCH, lp, lp, 3), (BATCH, PATCH, PATCH, 3))
    nbytes = sum(4 * int(np.prod(sh)) for sh in shapes)
    slots = {'pageable': tuple(np.zeros(sh, np.float32) for sh in shapes)}
    if card:
        slots['pinned'] = tuple(torch.zeros(sh, pin_memory=True).numpy()
                                for sh in shapes)
    srcs = tuple(np.ones(sh, np.float32) for sh in shapes)
    copy_ms = {}

    def report(what, name, ms):
        rate = 2 * nbytes / ms / 1e6
        share = '' if what == 'memcpy' else \
            f', {copy_ms[name] / ms:.3f} of memcpy\'s rate'
        print(f'{what} of a batch ({nbytes / 2 ** 20:.4f} MiB) into {name} '
              f'slots: {ms:.3f} ms, {rate:.2f} GB/s read + written{share} '
              f'[{where}]')

    for name, (out_lr, out_hr) in slots.items():
        times = []
        for _ in range(args.batches):
            t0 = time.perf_counter()
            np.copyto(out_lr, srcs[0])
            np.copyto(out_hr, srcs[1])
            times.append(time.perf_counter() - t0)
        copy_ms[name] = _median_ms(times)
        report('memcpy', name, copy_ms[name])
        times = []
        for _ in range(args.batches):
            idx = rng.integers(0, args.images, BATCH)
            ys = rng.integers(0, 64 - lp + 1, BATCH)
            xs = rng.integers(0, 64 - lp + 1, BATCH)
            t0 = time.perf_counter()
            for j, i in enumerate(idx):
                y, x = ys[j], xs[j]
                out_lr[j] = lrs[i][y:y + lp, x:x + lp]
                out_hr[j] = hrs[i][y * SCALE:(y + lp) * SCALE,
                                   x * SCALE:(x + lp) * SCALE]
            times.append(time.perf_counter() - t0)
        report('numpy gather, 1 thread, no augment,', name,
               _median_ms(times))

    for name, (out_lr, out_hr) in slots.items():
        for nthreads in (1, 2, 4, 8):
            for rotate in (False, True):
                times = []
                for _ in range(args.batches):
                    idx = rng.integers(0, args.images, BATCH)
                    draws = (rng.integers(0, 64 - lp + 1, BATCH),
                             rng.integers(0, 64 - lp + 1, BATCH),
                             rng.integers(0, 4, BATCH) if rotate
                             else np.zeros(BATCH),
                             rng.integers(0, 2, BATCH),
                             rng.integers(0, 2, BATCH))
                    t0 = time.perf_counter()
                    native.extract_patch_batch(
                        [lrs[i] for i in idx], [hrs[i] for i in idx], PATCH,
                        SCALE, *draws, out_lr, out_hr, nthreads=nthreads)
                    times.append(time.perf_counter() - t0)
                report(f'native batch, {nthreads} thread(s), '
                       f'{"random" if rotate else "no"} rotations,', name,
                       _median_ms(times))

    source = _RamSource(lrs, hrs)
    out_lr, out_hr = slots['pinned' if card else 'pageable']
    for workers in (1, 4):
        loader = TrainLoader(source, BATCH, PATCH, SCALE, num_workers=workers)
        parts = {'fetch': [], 'draw': [], 'native': []}
        for _ in range(args.batches):
            idx = rng.permutation(args.images)[:BATCH]
            t0 = time.perf_counter()
            items, hr_items, _ = loader._fetch_items(idx)
            t1 = time.perf_counter()
            draws = loader._draw_params(rng, items)
            t2 = time.perf_counter()
            native.extract_patch_batch(items, hr_items, PATCH, SCALE, *draws,
                                       out_lr, out_hr, nthreads=workers)
            t3 = time.perf_counter()
            for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[key].append(dt)
        loader.close()
        print(f'producer parts a batch, num_workers {workers}: ' + ', '.join(
            f'{key} {_median_ms(v):.3f} ms' for key, v in parts.items())
            + f' [{where}]')
    if card:
        after_fit(where)


if __name__ == '__main__':
    main()
