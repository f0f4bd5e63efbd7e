"""Drive srtpu_torch's EDSR-baseline x4, RCAN-10x16 x4, SRResNet x4,
RDN-B x4, DDBPN x4, WDSR-B x4 and SRGAN x4 predict and training on one
CUDA card.

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
2c. K5 (RCAN's RCAB) forward and backward against their plain versions:
   one RCAB and one 16-block residual group at the training shape
   (batch 16, LR 32x32), one RCAB at the predict shape (batch 1,
   128x128) and at a ragged batch 2 of 67x45: the forward's out, h1 and
   r2, the backward's dx and eight f32 grads (the group's: ten), errors
   beside tolerances, two calls bit-identical, kernel and plain times;
5. the RCAN predict slice: phase 3's path and images with ``--model
   RCAN`` at full width and depth (64 features, 10 groups of 16 RCABs,
   reduction 16): per image 160 K5 forward and 11 K2 forward launches,
   no K1 or K3; PNGs at 4x; kernel path against plain path; device
   time by kernel group of the 512x352 forward (torch.profiler);
6. the RCAN fit slice: phase 4 with ``--model RCAN`` at full width and
   depth: every K5 and K2 forward and backward on every step, the loss
   falling, kernel-path against plain-path steps, ms/step and patches/s,
   device time by kernel group.
2d. K4 (SRResNet's BatchNorm block) against its plain versions: each of
   its six functions (F1, F2, F3, B1, B2, B3) at the training shape
   (batch 16, LR 32x32, 64 channels) and at a ragged batch 2 of 67x45,
   every output (y, h1, the statistics, out, the sums S_g / S_gx =
   dbeta / dgamma, dz, dy, du, db, dalpha) within per-element limits
   (bn_block.kernel_limits: an f32 sum within its f32 rounding), the
   backward fed sums that make db a real value, a db summed from the
   bf16 dy shown to fail its limit, two calls bit-identical, kernel and
   plain times; then a 16-block trunk + close, forward and backward
   (every grad, dW1 / dW2 through the weight-grad kernel, and the
   running statistics) against an f32 path, and two faults planted in
   B2 caught by that check: besides every tensor's largest error, each
   block's BN2 backward dy per element against the f32 path, and its
   invariants (per channel, dy sums to 0 and is orthogonal to xhat, so
   mean(dy) and mean(dy * xhat) are 0 in f32) against the f32 path's;
   the margin of each fault is printed. Phases 2 and 2b also hold K2 at 5x5
   (SRResNet's phase-dense 256 -> 16) forward and backward at the tail's
   shapes;
7. the SRResNet predict slice: phase 3's path and images with ``--model
   SRResNet`` (64 features, 16 resblocks, x4): eval mode, so per image
   K3 1, K2 3x3 1, K2 5x5 1 and no K4; PNGs at 4x; kernel path against
   plain path;
8. the SRResNet fit slice: phase 4 with ``--model SRResNet`` at full
   width and depth: per step F1, F3, B1, B3 17 times (16 blocks + the
   close), F2 and B2 16, K2 and K3 forward and backward, 36 weight-grad
   launches; the loss falling, the running statistics finite and moved;
   the gradients of a kernel-path and a plain-path step against an f32
   step (with phase 2d's per-block dy checks), the planted faults caught
   there too; five steps' losses,
   ms/step, patches/s, device time by kernel group.
2e. K6 (RDN's dense-block trunk) against its plain versions at the full
   B config (16 blocks of 8 layers, G = G0 = 64): the forward (cat and
   every saved buffer; the predict variant's shared buffer gives the
   same cat), one block's backward chain (dx, dout, dwf, dbf, db) and
   its 36 pair weight grads, at the training shape (batch 16, LR 32x32),
   the predict shape (batch 1, 128x128) and a ragged batch 2 of 67x45,
   every output beside its tolerance, two calls bit-identical, kernel
   and plain times;
9. the RDN predict slice: phase 3's path and images with ``--model RDN``
   (config B): per image one K6 forward and two K2 (SFE2, GFF2), no other
   kernel; PNGs at 4x; kernel path against plain path; device time by
   kernel group of the 512x352 forward;
10. the RDN fit slice: phase 4 with ``--model RDN`` at full width and
   depth: per step one K6 forward, 16 chains and 16 pair weight-grad
   calls, K2 2 + 2 and its 2 weight grads; the loss falling, kernel-path
   against plain-path gradients and losses, ms/step, patches/s, device
   time by kernel group.
2f. K2's general path (c_in walked in chunks; any multiples of 16)
   against its plain version at every shape DDBPN and the x3 tails give
   it: forward 32 -> 512, 512 -> 32, 512 -> 48 (x4), 32 -> 128, 128 -> 32,
   128 -> 16 (x2) and 576 -> 32 at 3x3 and 5x5 (x3), and the backward of
   each (dx the reverse shape, dW and db through the weight-grad kernel's
   general path), at the training shape (batch 16, LR 32x32), the
   predict shape (batch 1, 128x128) and a ragged batch 2 of 67x45; errors
   beside K2's tolerances, two calls bit-identical, kernel, plain and
   library times;
11. the DDBPN predict slice: phase 3's path and images with ``--model
   DDBPN`` at srtpu's defaults (n0 128, nr 32, depth 6): per image 39 K2
   forward launches on the general path (33 projection convs, 6
   output-conv blocks) and no K1, K3, K4, K5 or K6; PNGs at 4x; kernel
   path against plain path; device time by kernel group of the 512x352
   forward;
12. the DDBPN fit slice: phase 4 with ``--model DDBPN`` at the defaults:
   per step 39 K2 forward, 39 K2 dx and 39 weight-grad launches, the loss
   falling, every dead-tap weight gradient exactly 0, kernel-path against
   plain-path gradients and losses, ms/step, patches/s, device time by
   kernel group;
13. EDSR and SRResNet at x3 on the card: one predict image each through
   the CLI (their phase-dense 576 -> 32 tails, 3x3 and 5x5, on K2's
   general path), kernel path against plain path.
2g. K7 (WDSR-B's block) forward and backward against their plain
   versions at C = 128 (e 768, Lp 112): the training shape (batch 16, LR
   32x32), the predict shape (batch 1, 128x128) and a ragged batch 2 of
   67x45; out, dx and the six f32 grads beside their tolerances, two
   calls bit-identical, kernel, plain and bound times (the bound counts
   the block's work at its bottleneck L = 102, not the kernels' padded
   Lp), and one bf16 block on cuDNN (channels-last weights, benchmark
   mode) timed each way beside;
14. the WDSR-B predict slice: phase 3's path and images with ``--model
   WDSR --use_pallas cs`` at srtpu's defaults (128 features, 16 blocks,
   x4): per image 16 K7 forward launches and no K1-K6; PNGs at 4x;
   kernel path against plain path; device time by kernel group at
   512x352; the same images' forward times on the stock route
   (``--use_pallas false``, same weights) beside;
15. the WDSR-B fit slice: phase 4 with ``--model WDSR --use_pallas cs``:
   per step 16 K7 forward and 16 K7 backward launches, the loss falling,
   kernel-path against plain-path gradients (v, g and bias of every conv)
   and losses, ms/step, patches/s, device share and time by kernel
   group, and the stock route's step from the same params beside;
16. a short SRResNet x3 fit (4 BN blocks, LR 32x32 patches, 10 steps):
   the 5x5 phase-dense 576 -> 32 conv's backward (dx 32 -> 576 and its
   weight grads) on K2's general path on a main path, gradients against
   an f32 step.
2h. K4r (K4 with REFLECT boundaries, SRGAN's generator block): F1, F2,
   B2 and B3 with reflect=True against their plain versions at the
   training shape (batch 16, LR 32x32) and at a ragged batch 2 of 23x37,
   within bn_block.kernel_limits, two calls bit-identical; two planted
   faults, the forward's halo left at zero (the SAME kernel in place of
   F1 and F2) and B2 / B3 with the fold dropped, must fail those limits
   (each margin printed); each K4r function's time beside K4's on the
   same inputs; one reflect block on cuDNN in bf16 (channels-last
   weights, benchmark mode) timed beside a K4r block, forward and
   forward + backward;
17. the SRGAN predict slice: phase 3's path and images with ``--model
   SRGAN`` at srtpu's sizes (ngf = ndf = 64, 16 blocks, x4): eval mode,
   so no kernel of the port runs (the trunk on its running statistics
   through reflect-padded stock convs, as srtpu's eval on XLA); PNGs at
   4x; the forward times;
18. the SRGAN fit slice: ``fit --model SRGAN --use_pallas cs`` at batch
   16, patch 128, 20 adversarial steps (D then G, VGG19 relu5_4 content
   term): per step K4r F1 and B3 17, F2 and B2 16, K4's F3 and B1 17 and
   33 reflect weight grads; g_loss and d_loss finite, the running
   statistics moved; a kernel-path and a plain-path step held to an f32
   step (every generator gradient, each block's BN2 dy); the step's time
   on the kernel and plain paths (and the kernel path with TF32 off),
   patches/s, the device share and device time by group (K4r, Adam, the
   rest; D, VGG19 and the generator timed alone).
The line before the last is a JSON object with, per kernel, its launches
in the main-path runs (EDSR, RCAN, SRResNet, RDN, DDBPN, WDSR and SRGAN
predict and fit, EDSR and SRResNet x3 predict, SRResNet x3 fit;
``launches`` is their sum), its largest error against its plain
version, its time (K4's and K4r's: its kernels' own device time from
torch.profiler; the others: the wrapper's CUDA-event time) and the
plain version's at the main path's shapes, the least time the card could take for the same
work (``bound_ms``: the larger of the bytes the function must move over
3.35 TB/s and its matrix FLOPs over 989 TFLOP/s bf16, NVIDIA's H100 SXM
figures) and the time of one
PyTorch call computing the same function where there is one
(``library_ms``, a yardstick the port never calls). The last line is
``{"ok": true, "device": {...}}``. Without CUDA (or without the repo)
it exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
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
import torch.nn.functional as F

from srtpu_torch import cli
from srtpu_torch.data import pad_to_bucket
from srtpu_torch.losses import VGGLoss, parse_losses
from srtpu_torch.models import create_model
from srtpu_torch.ops import (_build, b1_plain, b1_sums, b2_call, b2_plain,
                             b3_call, b3_plain, bn_block, conv3x3_bwd,
                             conv3x3_bwd_plain, conv3x3_fwd, conv3x3_plain,
                             conv_wgrad, conv_wgrad_plain, f1_conv_stats,
                             f1_plain,
                             f2_norm_act_conv_stats, f2_plain, f3_norm_skip,
                             f3_plain, rcab_bwd, rcab_bwd_plain,
                             rcab_fwd, rcab_fwd_plain, resgroup_bwd,
                             resgroup_bwd_plain, resgroup_fwd, resgroup_plain,
                             trunk_bwd, trunk_bwd_plain, trunk_fwd,
                             trunk_plain, upsample_bwd, upsample_bwd_plain,
                             upsample_fwd, upsample_plain)
from srtpu_torch.ops.layout import w_t
from srtpu_torch.ops.rdn import (pack, rdb_bwd_chain, rdb_bwd_chain_plain,
                                 rdb_bwd_dw, rdb_bwd_dw_plain, rdn_fwd,
                                 rdn_fwd_plain)
from srtpu_torch.ops.wdsr import (wdsr_bwd, wdsr_bwd_plain, wdsr_fwd,
                                  wdsr_fwd_plain, wdsr_lp)
from srtpu_torch.optim import build_optimizer
from srtpu_torch.train import (TrainState, create_gan_state,
                               make_gan_train_step, make_train_step)
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
TOL_STEPS = {'K1': 4, 'K2': 1, 'K3': 1, 'K25': 1}
# Backward: dx as the forward (K1's chain: four steps over 16 blocks);
# dW / db sum the same bf16 products in f32 in another order, 1e-4 of
# the largest magnitude; K1's weight grads read its bf16 dh1 chain,
# where a value may sit one step apart: one step.
BWD_DX_STEPS = {'K1': 4, 'K2': 1, 'K3': 1, 'K25': 1}
BWD_DW_STEPS = {'K1': 1, 'K2': None, 'K3': None, 'K25': None}
# Train step, kernel path vs plain path from the same params and batch:
# every gradient within 2^-6 of its largest magnitude (the paths' bf16
# activations may sit a step apart through 16 blocks, and the backward
# carries that on); losses over five steps within 2^-10 relative.
STEP_GRAD_TOL, STEP_LOSS_TOL = 2.0 ** -6, 2.0 ** -10
# RCAN's attention MLP (wd, bd, wu, bu): their grads pass through the
# ReLU mask of z, C/r = 4 values per image recomputed from each path's
# bf16 r2; a z next to 0 can flip for one image and move the grad by
# that image's whole term (of 16), so 2^-4 of the largest magnitude.
MLP_STEP_GRAD_TOL = 2.0 ** -4
MLP_PARAMS = ('.wd', '.bd', '.wu', '.bu')
# SR image in [0, 1], kernel path vs plain path: every K1 difference
# passes through the tail's convs (gain < 1 at this init).
SLICE_MAX_TOL, SLICE_MEAN_TOL = 2.0 ** -5, 2.0 ** -9

# RCAN-10x16 x4 (srtpu bench.py's flagship of the family)
GROUPS, RCABS, REDUCTION = 10, 16, 16
CR = C // REDUCTION
RCAN_ARGS = ['--n_resgroups', str(GROUPS), '--n_resblocks', str(RCABS),
             '--reduction', str(REDUCTION)]
# per image of an RCAN x4 predict: one K5 forward per RCAB; K2 the ten
# group close convs and the trunk close conv; the tail is cuDNN
RCAN_PREDICT_LAUNCHES = {rcab_fwd: GROUPS * RCABS, conv3x3_fwd: GROUPS + 1,
                         trunk_fwd: 0, upsample_fwd: 0}
# per RCAN train step: K5 each way per RCAB, K2 each way per close conv,
# the weight grads once per K2 backward and twice per group (all 16
# RCABs' dW1 in one launch, dW2 in another)
RCAN_STEP_LAUNCHES = {rcab_fwd: GROUPS * RCABS, rcab_bwd: GROUPS * RCABS,
                      conv3x3_fwd: GROUPS + 1, conv3x3_bwd: GROUPS + 1,
                      conv_wgrad: GROUPS + 1 + 2 * GROUPS, trunk_fwd: 0,
                      trunk_bwd: 0, upsample_fwd: 0, upsample_bwd: 0}
# K5 against its plain version: one bf16 step of the largest magnitude
# per RCAB (out, h1, r2, dx, the conv weight grads: they read the bf16
# dr2 and dh1, which follow a gate whose f32 sums run in another order);
# the pool / MLP grads, f32 sums in another order: 1e-4 relative. Over a
# 16-block group four steps for everything, as K1's trunk: a step in one
# block's output moves every later block's pool, gate and grads.
RCAB_STEPS, RCAB_MLP_REL, GROUP_STEPS = 1, 1e-4, 4
# SRResNet x4 (srtpu bench.py's row, srtpu's defaults): 64 features, 16
# BN resblocks, the CLI's shared --n_feats / --n_resblocks
K4_FNS = {'F1': f1_conv_stats, 'F2': f2_norm_act_conv_stats,
          'F3': f3_norm_skip, 'B1': b1_sums, 'B2': b2_call, 'B3': b3_call}
K4_PLAIN = {'F1': f1_plain, 'F2': f2_plain, 'F3': f3_plain, 'B1': b1_plain,
            'B2': b2_plain, 'B3': b3_plain}
# K2's 5x5 launches, counted apart by its wrappers (a counter is a
# wrapper's ``launches`` or a (wrapper, attribute) pair)
CONV5_FWD, CONV5_BWD = (conv3x3_fwd, 'launches_5x5'), (conv3x3_bwd,
                                                       'launches_5x5')
# per image of an SRResNet x4 predict: eval mode runs the BN trunk on its
# running statistics through stock convs (srtpu's XLA path), so no K4;
# the tail runs K3 (first x2 stage), K2 3x3 (phase-major last stage) and
# K2 5x5 (the 9x9 output conv, phase-dense)
SRRESNET_PREDICT_LAUNCHES = {upsample_fwd: 1, conv3x3_fwd: 1, CONV5_FWD: 1,
                             trunk_fwd: 0, rcab_fwd: 0,
                             **{fn: 0 for fn in K4_FNS.values()}}
# per SRResNet train step: F1, F3, B1, B3 in every block and the close,
# F2 and B2 in every block; the tail's K2 and K3 each way; weight grads
# twice per block, once for the close, the K2 3x3 and 5x5 and K3
SRRESNET_STEP_LAUNCHES = {
    f1_conv_stats: L + 1, f2_norm_act_conv_stats: L, f3_norm_skip: L + 1,
    b1_sums: L + 1, b2_call: L, b3_call: L + 1, conv3x3_fwd: 1,
    conv3x3_bwd: 1, CONV5_FWD: 1, CONV5_BWD: 1, upsample_fwd: 1,
    upsample_bwd: 1, conv_wgrad: 2 * L + 4, trunk_fwd: 0, trunk_bwd: 0,
    rcab_fwd: 0, rcab_bwd: 0}
# K4 against its plain version, one function on the same inputs: per
# element limits from bn_block.kernel_limits (a bf16 output one step of
# its largest magnitude; an f32 sum its f32 rounding, 2^-20 of the sum of
# its terms' magnitudes, plus what the bf16 values it reads differ by).
# The 16-block trunk + close: each batch norm divides a difference by
# its channel's batch deviation and the skips carry it on, so the kernel
# and plain bf16 paths are each held to the f32 path: the kernel's error
# within BN_TRUNK_VS_F32 times the plain path's (plus one bf16 step); the
# running statistics kernel vs plain within 2^-6 of their magnitude.
BN_TRUNK_VS_F32, BN_TRUNK_STAT_REL = 2.0, 2.0 ** -6
# A conv bias right before a batch norm gets no gradient (the BN subtracts
# the batch mean): its gradient, sum dy, is f32 rounding noise on every
# path, held to the f32 rounding of that sum (bn_block.F32_SUM of its
# bn_block.db_scale per channel, taken on the f32 path).
PRE_BN = ('b1', 'b2', 'close_b')
# the K4 kernels' names (torch.profiler), for their own device time
K4_KERNELS = ('bn_conv_stats_kernel', 'bn_norm_skip_kernel', 'bn_sums_kernel',
              'bn_bwd_conv_kernel', 'bn_reduce_kernel', 'bn_fold_ring_kernel')
# K4r (SRGAN's generator block): F1, F2, B2 and B3 with reflect=True,
# counted apart from K4's SAME launches; F3 and B1 pad nothing and are
# K4's own. Phase 2h's shapes: the training shape and a ragged one (not a
# multiple of the 7 x 16 tile).
K4R = ('F1', 'F2', 'B2', 'B3')
K4R_COUNTERS = {k: (K4_FNS[k], 'launches_reflect') for k in K4R}
K4R_SIZES = ((TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE),
             (2, 23, 37))
# RDN-B x4 (srtpu bench.py:115-116, rdn_config='B'): 16 blocks of 8 dense
# layers at growth G = G0 = 64; the CLI's --rdn_config / --growth0
RDN_D, RDN_C, RDN_G0 = 16, 8, 64
RDN_ARGS = ['--rdn_config', 'B', '--growth0', str(RDN_G0)]
RDN_PAIRS = RDN_C * (RDN_C + 1) // 2
# per image of an RDN x4 predict: one K6 forward (all 16 blocks), K2 for
# SFE2 and GFF2; SFE1, GFF1 and the tail are cuDNN / a matmul
RDN_PREDICT_LAUNCHES = {rdn_fwd: 1, conv3x3_fwd: 2, rdb_bwd_chain: 0,
                        rdb_bwd_dw: 0, trunk_fwd: 0, rcab_fwd: 0,
                        upsample_fwd: 0}
# per RDN train step: K6 forward once, its chain and pair weight grads
# once per block; K2 each way for SFE2 and GFF2 with their weight grads
RDN_STEP_LAUNCHES = {rdn_fwd: 1, rdb_bwd_chain: RDN_D, rdb_bwd_dw: RDN_D,
                     conv3x3_fwd: 2, conv3x3_bwd: 2, conv_wgrad: 2,
                     trunk_fwd: 0, trunk_bwd: 0, rcab_fwd: 0, rcab_bwd: 0,
                     upsample_fwd: 0, upsample_bwd: 0}
# K6 against its plain version on the same inputs. Both round at the same
# points; a value next to a bf16 rounding boundary lands a step apart and
# the later layers of its block read it, and the block skips carry it on
# through 16 blocks: the forward's cat and buffers within four steps of
# their largest magnitude (K1's trunk), one block's chain dx and dout
# within two. db sums the f32 dout behind such a value: one step. dwf,
# dbf and the pair weight grads sum the same bf16 operands in another
# order: 1e-4 relative.
K6_STEPS, K6B_STEPS = 4, {'dx': 2, 'dout': 2, 'dwf': 1e-4, 'dbf': 1e-4,
                          'db': 1}
# Each block's BN2 backward dy against the f32 path (phase 2d's trunk and
# phase 8's step): per element within BN_TRUNK_VS_F32 times the plain
# path's largest error in its channel plus one bf16 step of the element;
# its invariants, mean(dy) and mean(dy * xhat) per channel (0 in f32: the
# BN backward subtracts both projections), within BN_INVARIANT_VS_F32
# times the plain path's largest error of that block's row. A term missing
# from dy breaks the invariants coherently over all of a channel's pixels.
BN_INVARIANT_VS_F32 = 4.0
# K2's general path (conv_chunked_kernel) and the weight-grad kernel's
# (wgrad_chunk_kernel), counted apart from the instances of their own
K2G_FWD, K2G_BWD = (conv3x3_fwd, 'launches_general'), (conv3x3_bwd,
                                                       'launches_general')
K2G5_FWD = (conv3x3_fwd, 'launches_general_5x5')
WGG = (conv_wgrad, 'launches_general')
# SRGAN x4 at srtpu's sizes (srtpu/models/srgan.py:146-150, bench.py's
# recipe): ngf = ndf = 64, 16 blocks, on srtpu's kernel route's key
SRGAN_ARGS = ['--ngf', str(C), '--ndf', str(C), '--n_blocks', str(L),
              '--use_pallas', 'cs']
# per image of an SRGAN x4 predict: eval mode, no kernel of the port
SRGAN_PREDICT_LAUNCHES = {**{k: 0 for k in K4R_COUNTERS.values()},
                          **{fn: 0 for fn in K4_FNS.values()},
                          conv3x3_fwd: 0, upsample_fwd: 0, conv_wgrad: 0}
# per SRGAN train step: K4r F1 and B3 in every block and the close, F2
# and B2 in every block; K4's F3 and B1 likewise; the reflect weight
# grads twice per block and once for the close; no SAME K4, K2 or K3
SRGAN_STEP_LAUNCHES = {
    K4R_COUNTERS['F1']: L + 1, K4R_COUNTERS['F2']: L,
    K4R_COUNTERS['B2']: L, K4R_COUNTERS['B3']: L + 1, f3_norm_skip: L + 1,
    b1_sums: L + 1, conv_wgrad: 2 * L + 1, WGG: 0,
    **{K4_FNS[k]: 0 for k in K4R}, conv3x3_fwd: 0, conv3x3_bwd: 0,
    upsample_fwd: 0, upsample_bwd: 0}
# (c_in, c_out, k) at which DDBPN and the x3 tails run K2's general path:
# DDBPN x4 (nr 32) up, down and output convs, x2 up, down and output
# convs, EDSR's and SRResNet's x3 phase-dense convs; each backward's dx
# is the reverse shape (x2's 16 -> 128 an instance of its own)
K2G_SHAPES = ((32, 512, 3), (512, 32, 3), (512, 48, 3), (32, 128, 3),
              (128, 32, 3), (128, 16, 3), (576, 32, 3), (576, 32, 5))
K2G_X4 = K2G_SHAPES[:3]       # DDBPN x4's: the main path's (JSON times)
# DDBPN x4 at srtpu's defaults (srtpu/models/ddbpn.py:220-229, timed by
# srtpu's bench.py:118-119): n0 128, nr 32, depth 6; the CLI's flags
DDBPN_N0, DDBPN_NR, DDBPN_DEPTH = 128, 32, 6
DDBPN_ARGS = ['--n0', str(DDBPN_N0), '--nr', str(DDBPN_NR), '--depth',
              str(DDBPN_DEPTH)]
# three projection convs in each of the 2 depth - 1 units, one output conv
# per HR block: 33 + 6
DDBPN_CONVS = 3 * (2 * DDBPN_DEPTH - 1) + DDBPN_DEPTH
NO_FWD_BUT_K2G = {trunk_fwd: 0, upsample_fwd: 0, rcab_fwd: 0, rdn_fwd: 0,
                  conv3x3_fwd: 0, CONV5_FWD: 0,
                  **{fn: 0 for fn in K4_FNS.values()}}
# per image of a DDBPN x4 predict: every K2 on the general path
DDBPN_PREDICT_LAUNCHES = {K2G_FWD: DDBPN_CONVS, **NO_FWD_BUT_K2G}
# per DDBPN x4 train step: K2 forward, dx and weight grads per conv
DDBPN_STEP_LAUNCHES = {K2G_FWD: DDBPN_CONVS, K2G_BWD: DDBPN_CONVS,
                       WGG: DDBPN_CONVS, conv3x3_bwd: 0, conv_wgrad: 0,
                       trunk_bwd: 0, upsample_bwd: 0, rcab_bwd: 0,
                       rdb_bwd_chain: 0, rdb_bwd_dw: 0, **NO_FWD_BUT_K2G}
# per image of an x3 predict (one stage of r = 3, no K3): EDSR's trunk K1,
# K2 for the close and the phase-major 64 -> 576 (instances of their own)
# and the phase-dense 576 -> 32 (general); SRResNet's (eval mode, no K4)
# 64 -> 576 and its 5x5 576 -> 32 (general)
EDSR_X3_LAUNCHES = {trunk_fwd: L, conv3x3_fwd: 2, K2G_FWD: 1, upsample_fwd: 0}
SRRESNET_X3_LAUNCHES = {conv3x3_fwd: 1, K2G5_FWD: 1, CONV5_FWD: 0,
                        upsample_fwd: 0, trunk_fwd: 0,
                        **{fn: 0 for fn in K4_FNS.values()}}
# SRResNet x3 fit (the 5x5 phase-dense 576 -> 32 backward on K2's general
# path): 4 BN blocks (cut from 16: the tail is what it exercises), batch
# 16 of LR 32x32 (patch 96), 10 steps; the counters it is sure of
K2G5_BWD = (conv3x3_bwd, 'launches_general_5x5')
X3_FIT_BLOCKS, X3_FIT_PATCH, X3_FIT_STEPS = 4, 96, 10
SRRESNET_X3_STEP_LAUNCHES = {conv3x3_fwd: 1, K2G5_FWD: 1, K2G5_BWD: 1,
                             WGG: 1, CONV5_FWD: 0, CONV5_BWD: 0,
                             upsample_fwd: 0, upsample_bwd: 0}
# WDSR-B x4 at srtpu's defaults (srtpu/models/wdsr.py:124-133, srtpu
# bench.py:99-100): block B, 128 features, 16 blocks, res_scale 1, on
# srtpu's kernel route ('cs': K7 runs each block); the stock route
# (--use_pallas false: cuDNN weight-normed convs) is timed beside it
WDSR_C, WDSR_L = 128, 16
WDSR_E, (WDSR_LV, WDSR_LP) = 6 * WDSR_C, wdsr_lp(WDSR_C)
WDSR_ARGS = ['--n_feats', str(WDSR_C), '--n_resblocks', str(WDSR_L),
             '--use_pallas', 'cs']
WDSR_STOCK = ('--use_pallas', 'false')
NO_OTHER_FWD = {trunk_fwd: 0, upsample_fwd: 0, rcab_fwd: 0, rdn_fwd: 0,
                conv3x3_fwd: 0, K2G_FWD: 0, CONV5_FWD: 0, K2G5_FWD: 0,
                **{fn: 0 for fn in K4_FNS.values()}}
# per image of a WDSR-B x4 predict: one K7 forward per block; the skip,
# head and tail are cuDNN
WDSR_PREDICT_LAUNCHES = {wdsr_fwd: WDSR_L, wdsr_bwd: 0, **NO_OTHER_FWD}
# per WDSR-B train step: K7 each way per block (its backward's dW3 / db3
# launches are counted on K7b, not on the weight-grad kernel's counters)
WDSR_STEP_LAUNCHES = {wdsr_fwd: WDSR_L, wdsr_bwd: WDSR_L, conv3x3_bwd: 0,
                      K2G_BWD: 0, conv_wgrad: 0, WGG: 0, trunk_bwd: 0,
                      upsample_bwd: 0, rcab_bwd: 0, rdb_bwd_chain: 0,
                      **NO_OTHER_FWD}
# K7 against its plain version on the same inputs: h1 and h2 round at the
# same points, but a value next to a bf16 rounding boundary may land a
# step apart and the next product reads it: out and dx within two steps
# of their largest magnitude; the f32 weight and bias grads, sums of
# products of those bf16 values, within one step.
K7_STEPS = {'out': 2}
K7B_STEPS = {'dx': 2, 'dw1': 1, 'db1': 1, 'dw2': 1, 'db2': 1, 'dw3': 1,
             'db3': 1}
# The H100 SXM's published peaks (NVIDIA data sheet), for bound_ms
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12


def need(cond, msg: str) -> None:
    """Fail the run (an ``assert`` would vanish under ``python -O``)."""
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def _counter(key) -> tuple:
    """A launch counter as (wrapper, attribute): a wrapper's ``launches``,
    or a (wrapper, attribute) pair such as CONV5_FWD."""
    return key if isinstance(key, tuple) else (key, 'launches')


def _counter_name(key) -> str:
    fn, attr = _counter(key)
    return fn.__name__ if attr == 'launches' else f'{fn.__name__}.{attr}'


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


def nbytes(*objs) -> int:
    """Bytes of every tensor in objs (tuples and lists walked)."""
    total = 0
    for o in objs:
        if torch.is_tensor(o):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += nbytes(*o)
    return total


def bound(flops: float, moved: int) -> tuple[float, float]:
    """(ms the card needs for ``flops`` bf16 matrix FLOPs, ms it needs to
    move ``moved`` bytes once), at the published peaks."""
    return flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES_PER_S * 1e3


def new_stats(kids) -> dict:
    return {k: {'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0,
                'ops_ms': 0.0, 'bytes_ms': 0.0, 'bound_ms': 0.0,
                'library_ms': None} for k in kids}


def record(st: dict, ms: float, plain_ms: float, flops: float, moved: int,
           lib=None) -> None:
    """Add one use of a kernel at the main path's shapes to its stats:
    its time, the plain version's, its bound and the library call's."""
    ops_ms, bytes_ms = bound(flops, moved)
    st['ms'] += ms
    st['plain_ms'] += plain_ms
    st['ops_ms'] += ops_ms
    st['bytes_ms'] += bytes_ms
    st['bound_ms'] += max(ops_ms, bytes_ms)
    if lib is not None:
        st['library_ms'] = (st['library_ms'] or 0.0) + median_ms(lib)


def lib_conv(x, w, b):
    """One F.conv2d in bf16, channels-last: K2's forward yardstick."""
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bb = b.to(x.dtype)
    return lambda: F.conv2d(xc, wc, bb, padding=w.shape[0] // 2)


def lib_conv_bwd(x, w, g):
    """One aten.convolution_backward (dx, dW, db) in bf16: K2's backward
    yardstick."""
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    pad = w.shape[0] // 2
    return lambda: torch.ops.aten.convolution_backward(
        gc, xc, wc, [wc.shape[0]], [1, 1], [pad, pad], [1, 1], False, [0, 0],
        1, [True, True, True])


def lib_wgrad(x, g, k: int = 3):
    """One torch.nn.grad.conv2d_weight (k x k) in bf16 over J stacked jobs
    as J conv groups (dW only): the weight-grad kernel's yardstick."""
    j, b, h, w, c = x.shape
    co = g.shape[-1]
    cl = torch.channels_last
    xi = x.permute(1, 0, 4, 2, 3).reshape(b, j * c, h, w).contiguous(
        memory_format=cl)
    gi = g.permute(1, 0, 4, 2, 3).reshape(b, j * co, h, w).contiguous(
        memory_format=cl)
    return lambda: torch.nn.grad.conv2d_weight(xi, (j * co, c, k, k), gi,
                                               padding=k // 2, groups=j)


def conv_flops(bhw: int, cin: int, cout: int, k: int = 3) -> float:
    """Matrix FLOPs of one k x k conv over bhw output pixels."""
    return 2.0 * k * k * cin * cout * bhw


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
    """(kernel id, label, wrapper, plain, args, matrix FLOPs, library
    call or None) at the shapes predict gives each kernel for an h x w LR
    image."""
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
    # drawn in the order of the cases (the data of earlier runs)
    trunk = (act(1, h, w, C), w1, b1, w2, b2, 1.0)
    close = (act(1, h, w, C), *conv(C, C))
    ups = (act(1, h, w, C), *conv(C, 4 * C), 2)
    pm = (act(1, 2 * h, 2 * w, C), *conv(C, 4 * C))
    pd = (act(1, 2 * h, 2 * w, 4 * C), *conv(4 * C, 16))
    # SRResNet's phase-dense 9x9 output conv: 5x5, 256 -> 16
    w5 = _uniform(gen, (5, 5, 4 * C, 16), (25 * 4 * C) ** -0.5, device, bf)
    pd5 = (act(1, 2 * h, 2 * w, 4 * C), w5,
           _uniform(gen, (16,), 0.05, device, torch.float32))
    return [
        ('K1', f'trunk L={L} {h}x{w}', trunk_fwd, trunk_plain, trunk,
         2 * L * conv_flops(h * w, C, C), None),
        ('K2', f'close 64->64 {h}x{w}', conv3x3_fwd, conv3x3_plain, close,
         conv_flops(h * w, C, C), lib_conv(*close)),
        ('K3', f'upsample r=2 {h}x{w}', upsample_fwd, upsample_plain, ups,
         conv_flops(h * w, C, 4 * C), None),
        ('K2', f'phase-major 64->256 {2 * h}x{2 * w}', conv3x3_fwd,
         conv3x3_plain, pm, conv_flops(4 * h * w, C, 4 * C), lib_conv(*pm)),
        ('K2', f'phase-dense 256->16 {2 * h}x{2 * w}', conv3x3_fwd,
         conv3x3_plain, pd, conv_flops(4 * h * w, 4 * C, 16), lib_conv(*pd)),
        ('K25', f'phase-dense 5x5 256->16 {2 * h}x{2 * w}', conv3x3_fwd,
         conv3x3_plain, pd5, conv_flops(4 * h * w, 4 * C, 16, 5),
         lib_conv(*pd5)),
    ]


def check_kernels(device) -> dict:
    """Phase 2. Returns per kernel id: max error over all shapes, and
    kernel / plain / bound / library ms summed over its uses at the first
    (aligned) size."""
    stats = new_stats(TOL_STEPS)
    for i, (h, w) in enumerate(KERNEL_SIZES):
        for kid, label, fn, plain, args, flops, lib in kernel_cases(
                h, w, device):
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
                record(s, ms, plain_ms, flops, nbytes(args, got), lib)
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
    """(kernel id, label, wrapper, plain, args, matrix FLOPs, library
    call or None) at the shapes a train step gives each backward for a
    batch of h x w LR patches."""
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
    px, px2 = bsz * h * w, bsz * h2 * w2_
    # drawn in the order of the cases (the data of earlier runs)
    trunk = (xs, h1s, act(bsz, h, w, C), w1, w2, 1.0)
    close = (act(bsz, h, w, C), weight(C, C), act(bsz, h, w, C))
    ups = (act(bsz, h, w, C), weight(C, 4 * C), act(bsz, h2, w2_, C), 2)
    pm = (act(bsz, h2, w2_, C), weight(C, 4 * C), act(bsz, h2, w2_, 4 * C))
    pd = (act(bsz, h2, w2_, 4 * C), weight(4 * C, 16), act(bsz, h2, w2_, 16))
    pd5 = (act(bsz, h2, w2_, 4 * C),
           _uniform(gen, (5, 5, 4 * C, 16), (25 * 4 * C) ** -0.5, device, bf),
           act(bsz, h2, w2_, 16))
    # a backward is two convs' work: dx, and dW through the weight grads
    return [
        ('K1b', f'trunk bwd L={L} {bsz}x{h}x{w}', trunk_bwd, trunk_bwd_plain,
         trunk, 4 * L * conv_flops(px, C, C), None),
        ('K2b', f'close bwd 64->64 {bsz}x{h}x{w}', conv3x3_bwd,
         conv3x3_bwd_plain, close, 2 * conv_flops(px, C, C),
         lib_conv_bwd(*close)),
        ('K3b', f'upsample bwd r=2 {bsz}x{h}x{w}', upsample_bwd,
         upsample_bwd_plain, ups, 2 * conv_flops(px, C, 4 * C), None),
        ('K2b', f'phase-major bwd 64->256 {bsz}x{h2}x{w2_}', conv3x3_bwd,
         conv3x3_bwd_plain, pm, 2 * conv_flops(px2, C, 4 * C),
         lib_conv_bwd(*pm)),
        ('K2b', f'phase-dense bwd 256->16 {bsz}x{h2}x{w2_}', conv3x3_bwd,
         conv3x3_bwd_plain, pd, 2 * conv_flops(px2, 4 * C, 16),
         lib_conv_bwd(*pd)),
        ('W', f'weight grads of the trunk L={L} {bsz}x{h}x{w}', conv_wgrad,
         conv_wgrad_plain, (xs, h1s), L * conv_flops(px, C, C),
         lib_wgrad(xs, h1s)),
        ('K25b', f'phase-dense 5x5 bwd 256->16 {bsz}x{h2}x{w2_}',
         conv3x3_bwd, conv3x3_bwd_plain, pd5,
         2 * conv_flops(px2, 4 * C, 16, 5), lib_conv_bwd(*pd5)),
    ]


def check_bwd_kernels(device) -> dict:
    """Phase 2b. Returns per kernel id: max dx error (the weight-grad
    kernel: max dW error) over all shapes, and kernel / plain / bound /
    library ms summed over its uses at the training shapes."""
    stats = new_stats(('K1s', 'K1b', 'K2b', 'K3b', 'W', 'K25b'))
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
            record(st, median_ms(lambda: trunk_fwd(*args, save=True)),
                   median_ms(lambda: trunk_plain(*args, save=True)),
                   2 * L * conv_flops(bsz * h * w, C, C), nbytes(args, got))
            print(f'K1s trunk fwd, saving, L={L} {bsz}x{h}x{w}: kernel '
                  f'{st["ms"]:.4f} ms plain {st["plain_ms"]:.4f} ms')
        for kid, label, fn, plain, args, flops, lib in bwd_cases(
                bsz, h, w, device):
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
                record(st, ms, plain_ms, flops, nbytes(args, got), lib)
    return stats


def rcab_params(gen, device, lead=()):
    """One RCAB's (or a stack's) weights at srtpu's init bounds: conv
    weights bf16, biases and the attention MLP f32."""
    cb = 1.0 / (9 * C) ** 0.5
    f32 = torch.float32
    return (_uniform(gen, (*lead, 3, 3, C, C), cb, device, torch.bfloat16),
            _uniform(gen, (*lead, C), cb, device, f32),
            _uniform(gen, (*lead, 3, 3, C, C), cb, device, torch.bfloat16),
            _uniform(gen, (*lead, C), cb, device, f32),
            _uniform(gen, (*lead, C, CR), C ** -0.5, device, f32),
            _uniform(gen, (*lead, CR), C ** -0.5, device, f32),
            _uniform(gen, (*lead, CR, C), CR ** -0.5, device, f32),
            _uniform(gen, (*lead, C), CR ** -0.5, device, f32))


def _nearest(d, lim) -> int:
    """The flat index of the error ``d`` nearest its limit (the largest
    d / lim; a NaN error first)."""
    ratio = torch.nan_to_num(d / lim, nan=0.0, posinf=float('inf'))
    return int(torch.argmax(torch.where(d.isnan(), float('inf'), ratio)))


def _check_all(label, names, got, ref, tols) -> float:
    """Every output against its reference within its tolerance (steps of
    the largest magnitude; a float: that relative share of it; a tensor:
    per-element limits that broadcast to the output, printed at the
    element nearest its limit as error/limit@element, beside the largest
    error); returns the first output's largest error."""
    parts, first = [], None
    for name, g_t, r_t, tol in zip(names, got, ref, tols):
        steps = tol if isinstance(tol, int) else None
        err, lim, top = _err(g_t, r_t, steps)
        if torch.is_tensor(tol):
            d = (g_t.float() - r_t.float()).abs()
            lim_t = tol.float().expand_as(d)
            i = _nearest(d, lim_t)
            at, lim = d.flatten()[i].item(), lim_t.flatten()[i].item()
            parts.append(f'{name} {at:.4g}/{lim:.4g}@{i} (max {err:.4g}, '
                         f'|ref| {top:.4g})')
        else:
            if not isinstance(tol, int):
                lim = tol * top
            at = err
            parts.append(f'{name} {err:.4g}/{lim:.4g}')
        need(np.isfinite(at) and at <= lim, f'{label} {name}: {at} > {lim}')
        first = err if first is None else first
    print(f'{label}: max_abs/tol ' + ', '.join(parts))
    return first


def check_rcab_kernels(device) -> dict:
    """Phase 2c. K5's forward (saving) and backward against the plain
    versions, one RCAB at the training, predict and ragged shapes and a
    16-block group at the training shape; two calls bit-identical.
    Returns K5 / K5b stats, timed at the training shape (per RCAB call)."""
    stats = new_stats(('K5', 'K5b'))
    mlp_tol = [RCAB_MLP_REL] * 4
    bwd_names = ('dx', 'dw1', 'db1', 'dw2', 'db2', 'dwd', 'dbd', 'dwu', 'dbu')
    shapes = ((TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE),
              (1, 128, 128), (2, 67, 45))
    for i, (bsz, h, w) in enumerate(shapes):
        gen = torch.Generator().manual_seed(bsz * 7919 + h * 101 + w)
        prm = rcab_params(gen, device)
        x = _uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16)
        g = _uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16)
        tag = f'{bsz}x{h}x{w}'
        got = rcab_fwd(x, *prm, save=True)
        torch.cuda.synchronize()
        ref = rcab_fwd_plain(x, *prm, save=True)
        need(all(torch.equal(a, b) for a, b in
                 zip(got, rcab_fwd(x, *prm, save=True))),
             f'K5 fwd {tag}: two calls differ')
        err = _check_all(f'K5 rcab fwd (saving) {tag}', ('out', 'h1', 'r2'),
                         got, ref, [RCAB_STEPS] * 3)
        stats['K5']['max_abs_err'] = max(stats['K5']['max_abs_err'], err)
        # the backward from the plain forward's saved h1, r2
        bargs = (x, ref[1], ref[2], g, prm[0], prm[2], *prm[4:])
        bgot = rcab_bwd(*bargs)
        torch.cuda.synchronize()
        bref = rcab_bwd_plain(*bargs)
        need(all(torch.equal(a, b) for a, b in zip(bgot, rcab_bwd(*bargs))),
             f'K5 bwd {tag}: two calls differ')
        err = _check_all(f'K5 rcab bwd {tag}', bwd_names, bgot, bref,
                         [RCAB_STEPS] * 5 + mlp_tol)
        stats['K5b']['max_abs_err'] = max(stats['K5b']['max_abs_err'], err)
        fms = median_ms(lambda: rcab_fwd(x, *prm, save=True))
        fpl = median_ms(lambda: rcab_fwd_plain(x, *prm, save=True))
        bms = median_ms(lambda: rcab_bwd(*bargs))
        bpl = median_ms(lambda: rcab_bwd_plain(*bargs))
        nms = median_ms(lambda: rcab_fwd(x, *prm))
        print(f'K5 {tag}: fwd saving kernel {fms:.4f} ms plain {fpl:.4f} ms; '
              f'fwd (predict, no saving) kernel {nms:.4f} ms; bwd (incl. 2 '
              f'weight-grad launches) kernel {bms:.4f} ms plain {bpl:.4f} ms')
        if i == 0:
            px = bsz * h * w
            record(stats['K5'], fms, fpl, 2 * conv_flops(px, C, C),
                   nbytes(x, prm, got))
            record(stats['K5b'], bms, bpl, 4 * conv_flops(px, C, C),
                   nbytes(bargs, bgot))

    # a 16-block residual group at the training shape
    bsz, h, w = shapes[0]
    gen = torch.Generator().manual_seed(2024)
    w1, b1, w2, b2, wd, bd, wu, bu = rcab_params(gen, device, (RCABS,))
    wc = _uniform(gen, (3, 3, C, C), 1.0 / (9 * C) ** 0.5, device,
                  torch.bfloat16)
    bc = _uniform(gen, (C,), 1.0 / (9 * C) ** 0.5, device, torch.float32)
    prm = (w1, b1, w2, b2, wd, bd, wu, bu, wc, bc)
    x = _uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16)
    g = _uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16)
    tag = f'L={RCABS} {bsz}x{h}x{w}'
    got = resgroup_fwd(x, *prm, save=True)
    torch.cuda.synchronize()
    ref = resgroup_plain(x, *prm, save=True)
    need(all(torch.equal(a, b) for a, b in
             zip(got, resgroup_fwd(x, *prm, save=True))),
         f'group fwd {tag}: two calls differ')
    _check_all(f'K5 group fwd (saving) {tag}', ('out', 'xs', 'h1s', 'r2s'),
               got, ref, [GROUP_STEPS] * 4)
    bargs = (*ref[1:], g, w1, w2, wd, bd, wu, bu, wc)
    bgot = resgroup_bwd(*bargs)
    torch.cuda.synchronize()
    bref = resgroup_bwd_plain(*bargs)
    need(all(torch.equal(a, b) for a, b in zip(bgot, resgroup_bwd(*bargs))),
         f'group bwd {tag}: two calls differ')
    _check_all(f'K5 group bwd {tag}', (*bwd_names, 'dwc', 'dbc'), bgot, bref,
               [GROUP_STEPS] * 11)
    times = [median_ms(fn, 5, 3) for fn in (
        lambda: resgroup_fwd(x, *prm, save=True),
        lambda: resgroup_plain(x, *prm, save=True),
        lambda: resgroup_bwd(*bargs), lambda: resgroup_bwd_plain(*bargs))]
    print(f'K5 group {tag}: fwd saving kernel {times[0]:.4f} ms plain '
          f'{times[1]:.4f} ms; bwd kernel {times[2]:.4f} ms plain '
          f'{times[3]:.4f} ms')
    return stats


def _off_sums(gen, t, device) -> torch.Tensor:
    """A backward's two channel sums (2, C) drawn at random, at the scale
    of sums of t over its m pixels (sqrt(m) times its rms) but not t's:
    the BN's input gradient dy then does not sum to 0, so db = sum dy is
    a real value a wrong kernel cannot match by returning noise."""
    m = t.shape[0] * t.shape[1] * t.shape[2]
    rms = t.float().pow(2).mean().sqrt().item()
    return _uniform(gen, (2, C), m ** 0.5 * rms, device, torch.float32)


def bn_case(gen, device, bsz: int, h: int, w: int,
            reflect: bool = False) -> dict:
    """Inputs of one SRResNet BN block at 64 channels (srtpu's init bounds
    for the convs; BN scale and shift off their init), with the
    statistics, h1 and dz that F1, F2 and B2's plain versions give, and
    the backward's sums drawn apart from their cotangents (_off_sums);
    the conv functions' args end with ``reflect`` (SRGAN's block)."""
    bf, f32 = torch.bfloat16, torch.float32
    cb = 1.0 / (9 * C) ** 0.5
    u = _uniform(gen, (bsz, h, w, C), 1.0, device, bf)
    w1, w2 = (_uniform(gen, (3, 3, C, C), cb, device, bf) for _ in range(2))
    b1, b2 = (_uniform(gen, (C,), cb, device, f32) for _ in range(2))
    gam = [1.0 + _uniform(gen, (C,), 0.5, device, f32) for _ in range(2)]
    bet = [_uniform(gen, (C,), 0.3, device, f32) for _ in range(2)]
    alpha = torch.full((1,), 0.25, device=device)
    g = _uniform(gen, (bsz, h, w, C), 1.0, device, bf)
    rf = reflect
    y1, st1 = f1_plain(u, w1, b1, gam[0], bet[0], rf)
    y2, _, st2 = f2_plain(y1, st1, alpha, w2, b2, gam[1], bet[1], rf)
    sums2 = _off_sums(gen, g, device)
    dz = b2_plain(g, y2, st2, gam[1], sums2, y1, st1, alpha, w2, rf)[0]
    sums1 = _off_sums(gen, dz, device)
    px = bsz * h * w
    cf = conv_flops(px, C, C)
    return {
        'F1': ((u, w1, b1, gam[0], bet[0], rf), cf, ('y', 'st')),
        'F2': ((y1, st1, alpha, w2, b2, gam[1], bet[1], rf), cf,
               ('y2', 'h1', 'st2')),
        'F3': ((y2, st2, u), 0.0, ('out',)),
        'B1': ((g, y2, st2), 0.0, ('S_g, S_gx (dbeta2, dgamma2)',)),
        'B2': ((g, y2, st2, gam[1], sums2, y1, st1, alpha, w2, rf), cf,
               ('dz', 'dy2', 'db2', 'dalpha', 'S_dz, S_dzx (dbeta1, '
                'dgamma1)')),
        'B3': ((dz, y1, st1, gam[0], sums1, w1, g, rf), cf,
               ('du', 'dy1', 'db1'))}


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@contextlib.contextmanager
def _db_scales(scales: dict, prefix: str = ''):
    """Inside the block the plain B2 and B3 record each call's
    bn_block.db_scale per channel (whose f32 rounding bounds db = sum
    dy); on leaving, ``scales`` gets them under the pre-BN bias each
    belongs to: the backward runs the close's B3 first, then blocks L-1
    ... 0."""
    rec = {'b2': [], 'b3': []}
    saved = dict(bn_block.PLAIN)
    for key in rec:
        def call(*args, _fn=saved[key], _key=key):
            out = _fn(*args)
            rec[_key].append(bn_block.db_scale(*args[2:5], out[1]))
            return out
        bn_block.PLAIN[key] = call
    try:
        yield
    finally:
        bn_block.PLAIN.update(saved)
    scales[prefix + 'close_b'] = rec['b3'][0]
    scales[prefix + 'b1'] = torch.stack(rec['b3'][:0:-1])
    scales[prefix + 'b2'] = torch.stack(rec['b2'][::-1])


def _no_prelu_bwd(b2):
    """B2 without the PReLU backward: dz = dh1 where z < 0 too."""
    def call(g, y2, st2, ga2, sums2, y1, st1, alpha, *rest):
        return b2(g, y2, st2, ga2, sums2, y1, st1, torch.ones_like(alpha),
                  *rest)
    return call


def _no_xhat_t2(b2):
    """B2 whose BN2 backward drops dy's xhat * t2 term (S_gx read as 0)."""
    def call(g, y2, st2, ga2, sums2, *rest):
        return b2(g, y2, st2, ga2, sums2 * sums2.new_tensor([[1.0], [0.0]]),
                  *rest)
    return call


# faults planted in the kernel path's B2, each of which the trunk's and
# the train step's checks against the f32 path must catch
PLANTED = {'B2 without the PReLU backward': _no_prelu_bwd,
           "B2 without dy's xhat * t2 term": _no_xhat_t2}


@contextlib.contextmanager
def _planted(fault):
    """The kernel path's B2 replaced by ``fault`` of it inside the block."""
    b2 = bn_block.KERNELS['b2']
    bn_block.KERNELS['b2'] = fault(b2)
    try:
        yield
    finally:
        bn_block.KERNELS['b2'] = b2


def _vs_f32(got: dict, plain: dict, f32: dict, scales: dict) -> list:
    """(error / limit, text) per tensor of the kernel path ``got`` (by
    name) against the f32 path: within BN_TRUNK_VS_F32 times the plain
    bf16 path's error plus one bf16 step of |f32|'s largest; a pre-BN bias
    (in ``scales``, its db_scale per channel): |grad| within F32_SUM of
    that scale, its f32 rounding (the f32 path's grad is rounding noise
    too, so it is no reference there)."""
    rows = []
    for n, ref in f32.items():
        if n in scales:
            lim_t = bn_block.F32_SUM * scales[n]
            d = got[n].float().abs()
            i = _nearest(d, lim_t)
            e_k, lim = d.flatten()[i].item(), lim_t.flatten()[i].item()
            text = (f'{n} |grad| {e_k:.4g}/{lim:.4g}@{i} (largest: kernel '
                    f'{d.max().item():.4g}, plain '
                    f'{plain[n].abs().max().item():.4g}, scale '
                    f'{scales[n].max().item():.4g})')
        else:
            e_k = (got[n].float() - ref.float()).abs().max().item()
            e_p = (plain[n].float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            lim = BN_TRUNK_VS_F32 * e_p + bn_block.STEP * top
            text = f'{n} {e_k:.4g}/{e_p:.4g}/{lim:.4g} (|f32| {top:.4g})'
        rows.append((e_k / lim, text))
    return sorted(rows, key=lambda r: -r[0])


def _catches(rows: list, what: str, label: str) -> None:
    """A planted fault's rows: at least one over its limit. Prints the
    margin (the worst error/limit) and the per-block dy rows' own."""
    rows = sorted(rows, key=lambda r: -r[0])
    caught = [t for r, t in rows if not r <= 1.0]
    need(caught, f'{label}: the planted fault ({what}) passed')
    print(f'{label}, planted fault ({what}): caught by {len(caught)} of '
          f'{len(rows)} checks; margin (the worst error/limit) '
          f'{rows[0][0]:.4g}: ' + '; '.join(caught[:3]) + '; per block: '
          + ', '.join(f'{t} = {r:.4g}' for r, t in rows if 'BN2' in t))


@contextlib.contextmanager
def _dy_record(table: dict, store):
    """Inside the block, each call of ``table``'s B2 (bn_block.KERNELS or
    PLAIN; a planted fault included) appends its block's BN2 backward dy
    (f32) and that dy's invariants per channel, (mean(dy), mean(dy *
    xhat2)) as (2, C), to ``store`` (blocks L-1 ... 0). No-op for None."""
    if store is None:
        yield
        return
    saved = table['b2']

    def call(g, y2, st2, *rest):
        out = saved(g, y2, st2, *rest)
        dy = out[1].float()
        xh = bn_block._xhat(y2, st2)
        store.append((dy, torch.stack([dy.mean((0, 1, 2)),
                                       (dy * xh).mean((0, 1, 2))])))
        return out
    table['b2'] = call
    try:
        yield
    finally:
        table['b2'] = saved


def _dy_rows(rk: list, rp: list, rf: list) -> list:
    """(error / limit, text) rows of each block's BN2 backward dy on the
    kernel path (``rk`` from _dy_record) against the f32 path (``rf``),
    with the plain bf16 path's (``rp``) setting the scale: per element
    (BN_TRUNK_VS_F32 times the plain path's largest error in the element's
    channel plus one bf16 step of the element), and the invariants per
    block and channel (BN_INVARIANT_VS_F32 times the plain path's largest
    error of the block's row). The worst block of each."""
    need(len(rk) == len(rp) == len(rf) > 0, 'dy records per block')
    el, inv = (0.0, ''), (0.0, '')
    n = len(rk)
    for j, ((dk, pk), (dp, pp), (df, pf)) in enumerate(zip(rk, rp, rf)):
        lim = (BN_TRUNK_VS_F32 * (dp - df).abs().amax((0, 1, 2))
               + bn_block.STEP * df.abs())
        d = (dk - df).abs()
        i = _nearest(d, lim)
        r = (d.flatten()[i] / lim.flatten()[i]).item()
        if not r <= el[0]:
            el = (r, f"each block's BN2 dy per element {d.flatten()[i]:.4g}"
                     f"/{lim.flatten()[i]:.4g}@{i} (block {n - 1 - j})")
        lim_p = BN_INVARIANT_VS_F32 * (pp - pf).abs().amax(1, keepdim=True)
        dp_ = (pk - pf).abs()
        i = _nearest(dp_, lim_p.expand_as(dp_))
        r = (dp_.flatten()[i] / lim_p.expand_as(dp_).flatten()[i]).item()
        if not r <= inv[0]:
            what = ('mean(dy)', 'mean(dy*xhat)')[i // dp_.shape[1]]
            inv = (r, f"BN2 backward invariant {what} {dp_.flatten()[i]:.4g}"
                      f"/{lim_p.expand_as(dp_).flatten()[i]:.4g} (block "
                      f"{n - 1 - j}, channel {i % dp_.shape[1]}; |f32| "
                      f"{pf.abs().max().item():.3g})")
    return [el, inv]


def check_bn_kernels(device) -> dict:
    """Phase 2d. K4's six functions against their plain versions at the
    training shape and a ragged one (per-element limits of
    bn_block.kernel_limits; a db summed from the bf16 dy shown to fail
    them), two calls bit-identical, times at the training shape (the K4
    kernels' own device time from torch.profiler, and the wrapper's
    CUDA-event time); then a 16-block BN trunk + close, forward and
    backward, kernel path against plain path and f32 path, and each
    planted fault caught. Returns per-function stats."""
    stats = new_stats(K4_FNS)
    for i, (bsz, h, w) in enumerate(((TRAIN_BATCH, TRAIN_PATCH // SCALE,
                                      TRAIN_PATCH // SCALE), (2, 67, 45))):
        gen = torch.Generator().manual_seed(bsz * 7907 + h * 103 + w)
        case = bn_case(gen, device, bsz, h, w)
        tag = f'{bsz}x{h}x{w}'
        for kid, fn in K4_FNS.items():
            args, flops, names = case[kid]
            got = _as_list(fn(*args))
            torch.cuda.synchronize()
            ref = _as_list(K4_PLAIN[kid](*args))
            need(all(torch.equal(a, b) for a, b in
                     zip(got, _as_list(fn(*args)))),
                 f'K4 {kid} {tag}: two calls differ')
            tols = bn_block.kernel_limits(kid.lower(), args, ref, got)
            err = _check_all(f'K4 {kid} {tag}', names, got, ref, tols)
            if kid in ('B2', 'B3'):
                # srtpu sums the f32 dy into db: one summed from the bf16
                # dy (the operand of the weight grads) must fail the limit
                d16 = (ref[1].float().sum((0, 1, 2)) - ref[2]).abs()
                over = int((d16 > tols[2]).sum())
                print(f'K4 {kid} {tag}: a db summed from the bf16 dy would '
                      f'be off by up to {d16.max().item():.4g}, over its '
                      f'limit (up to {tols[2].max().item():.4g}) in {over} '
                      f'of {C} channels')
                need(over > 0, f'K4 {kid}: the db limit passes a bf16 sum')
            st = stats[kid]
            st['max_abs_err'] = max(st['max_abs_err'], err)
            if i == 0:
                ms = median_ms(lambda: fn(*args))
                dev_ms = _kernel_device_ms(lambda: fn(*args), K4_KERNELS)
                plain_ms = median_ms(lambda: K4_PLAIN[kid](*args))
                print(f'K4 {kid} {tag}: kernel {dev_ms:.4f} ms (its kernels'
                      f' on the device, torch.profiler; the wrapper call '
                      f'{ms:.4f} ms, CUDA events) plain {plain_ms:.4f} ms')
                record(st, dev_ms, plain_ms, flops, nbytes(args, got))

    # a 16-block trunk + close at the training shape, train mode
    bsz, h, w = TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE
    trunk = create_model('SRResNet', scale_factor=SCALE, n_feats=C,
                         n_resblocks=L, dtype=torch.bfloat16, device=device,
                         generator=torch.Generator().manual_seed(7)).trunk
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for name in ('bn1_scale', 'bn2_scale', 'close_bn_scale'):
            getattr(trunk, name).add_(
                _uniform(gen, getattr(trunk, name).shape, 0.5, device,
                         torch.float32))
    x = _uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16)
    g = _uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16)

    def run(dtype, plain, rec):
        m = copy.deepcopy(trunk).train()
        xi = x.to(dtype).clone().requires_grad_()
        with _dy_record(bn_block.PLAIN if plain else bn_block.KERNELS, rec):
            out = m(xi, dtype, plain)
            out.backward(g.to(dtype))
        return m, {'out': out, 'dx': xi.grad,
                   **{n: p.grad for n, p in m.named_parameters()}}

    # the kernel path, the plain path (both bf16) and the plain path in
    # f32 with no rounding at all, from one set of params and inputs
    scales, rk, rp, rf = {}, [], [], []
    mk, tk = run(torch.bfloat16, False, rk)
    mp, tp = run(torch.bfloat16, True, rp)
    with _db_scales(scales):
        _, tf = run(torch.float32, True, rf)
    torch.cuda.synchronize()
    # Through 16 batch norms the two bf16 paths part by more than a few
    # rounding steps (each BN divides a difference by its channel's batch
    # deviation), so both are held to the unrounded f32 path (_vs_f32),
    # and so is each block's BN2 backward dy (_dy_rows).
    rows = _vs_f32(tk, tp, tf, scales)
    dy_rows = _dy_rows(rk, rp, rf)
    label = f'K4 BN trunk L={L} + close {bsz}x{h}x{w}, fwd and bwd'
    print(f'{label}, max_abs vs the f32 path, kernel/plain/tol (|f32|): '
          + ', '.join(t for _, t in rows) + '; per block, error/limit: '
          + ', '.join(f'{t} = {r:.4g}' for r, t in dy_rows))
    rows = sorted(rows + dy_rows, key=lambda r: -r[0])
    need(all(r <= 1.0 for r, _ in rows),
         f'{label}: ' + '; '.join(t for r, t in rows if not r <= 1.0))
    bk, bp = dict(mk.named_buffers()), dict(mp.named_buffers())
    _check_all('K4 BN trunk running statistics, kernel vs plain', list(bk),
               list(bk.values()), list(bp.values()),
               [BN_TRUNK_STAT_REL] * len(bk))
    for what, fault in PLANTED.items():
        bad_dy = []
        with _planted(fault):
            _, bad = run(torch.bfloat16, False, bad_dy)
        _catches(_vs_f32(bad, tp, tf, scales) + _dy_rows(bad_dy, rp, rf),
                 what, label)

    def step(m, plain):
        xi = x.clone().requires_grad_()
        m(xi, torch.bfloat16, plain).backward(g)
    times = [median_ms(lambda: step(mk, False), 3, 3),
             median_ms(lambda: step(mp, True), 3, 3)]
    print(f'K4 BN trunk L={L} + close {bsz}x{h}x{w}: fwd + bwd kernel '
          f'{times[0]:.4f} ms plain {times[1]:.4f} ms')
    return stats


def _margin(got, ref, tols) -> float:
    """The worst error / limit over a function's outputs."""
    return max(((g.float() - r.float()).abs() / lim.float()).max().item()
               for g, r, lim in zip(got, ref, tols))


def stock_reflect_block(x, w1, b1, ga1, be1, alpha, w2, b2, ga2, be2):
    """One SRGAN generator block on stock PyTorch in bf16: reflect pad +
    cuDNN conv (weights channels-last, as lib_conv makes them), cuDNN
    batch norm on batch statistics, PReLU, again, + skip. x is an NCHW
    view of an NHWC tensor: K4r's yardstick, never called by the port."""
    def conv(t, w, b):
        return F.conv2d(F.pad(t, (1, 1, 1, 1), mode='reflect'), w, b)
    h = F.batch_norm(conv(x, w1, b1), None, None, ga1, be1, training=True,
                     eps=bn_block.EPS)
    h = F.batch_norm(conv(F.prelu(h, alpha), w2, b2), None, None, ga2, be2,
                     training=True, eps=bn_block.EPS)
    return h + x


def check_bn_reflect_kernels(device, smi: str) -> dict:
    """Phase 2h. K4r: F1, F2, B2 and B3 with reflect=True against their
    plain versions at the training shape and a ragged one (per-element
    limits of bn_block.kernel_limits), two calls bit-identical; the SAME
    kernel on the same inputs (F1, F2: the halo left at zero; B2, B3: the
    fold dropped) must fail those limits, margin printed; K4r's device
    times beside K4's on the same inputs; a K4r block and a bf16 cuDNN
    reflect block, forward and forward + backward. Returns the stats of
    F1r, F2r, B2r and B3r."""
    stats = new_stats([k + 'r' for k in K4R])
    for i, (bsz, h, w) in enumerate(K4R_SIZES):
        gen = torch.Generator().manual_seed(bsz * 7919 + h * 101 + w)
        case = bn_case(gen, device, bsz, h, w, reflect=True)
        tag = f'{bsz}x{h}x{w}'
        for kid in K4R:
            fn, plain = K4_FNS[kid], K4_PLAIN[kid]
            args, flops, names = case[kid]
            got = _as_list(fn(*args))
            torch.cuda.synchronize()
            ref = _as_list(plain(*args))
            need(all(torch.equal(a, b) for a, b in
                     zip(got, _as_list(fn(*args)))),
                 f'K4r {kid} {tag}: two calls differ')
            tols = bn_block.kernel_limits(kid.lower(), args, ref, got)
            err = _check_all(f'K4r {kid} {tag}', names, got, ref, tols)
            fault = ('the halo left at zero' if kid.startswith('F')
                     else 'the fold dropped')
            margin = _margin(_as_list(fn(*args[:-1], False)), ref, tols)
            print(f'K4r {kid} {tag}, planted fault ({fault}: the SAME '
                  f'kernel): margin (the worst error/limit) {margin:.4g}')
            need(margin > 1.0, f'K4r {kid} {tag}: {fault} passed')
            st = stats[kid + 'r']
            st['max_abs_err'] = max(st['max_abs_err'], err)
            if i == 0:
                dev_ms = _kernel_device_ms(lambda: fn(*args), K4_KERNELS)
                same_ms = _kernel_device_ms(lambda: fn(*args[:-1], False),
                                            K4_KERNELS)
                plain_ms = median_ms(lambda: plain(*args))
                print(f'K4r {kid} {tag}: kernel {dev_ms:.4f} ms (its '
                      f'kernels on the device, torch.profiler) against K4 '
                      f'(SAME) {same_ms:.4f} ms on the same inputs = '
                      f'{dev_ms / same_ms:.3f}x; plain {plain_ms:.4f} ms  '
                      f'[{smi}]')
                record(st, dev_ms, plain_ms, flops, nbytes(args, got))

    # one block, K4r against a bf16 cuDNN reflect block, at the training
    # shape with the same weights
    bsz, h, w = K4R_SIZES[0]
    gen = torch.Generator().manual_seed(17)
    cb = 1.0 / (9 * C) ** 0.5
    x = _uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16)
    g = _uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16)
    prm = [_uniform(gen, (3, 3, C, C), cb, device, torch.float32),
           _uniform(gen, (C,), cb, device, torch.float32),
           1.0 + _uniform(gen, (C,), 0.5, device, torch.float32),
           _uniform(gen, (C,), 0.3, device, torch.float32),
           torch.full((1,), 0.25, device=device),
           _uniform(gen, (3, 3, C, C), cb, device, torch.float32),
           _uniform(gen, (C,), cb, device, torch.float32),
           1.0 + _uniform(gen, (C,), 0.5, device, torch.float32),
           _uniform(gen, (C,), 0.3, device, torch.float32)]
    prm = [p.requires_grad_() for p in prm]
    cl = torch.channels_last
    sprm = [(p.detach().permute(3, 2, 0, 1) if p.dim() == 4 else p.detach())
            .to(torch.bfloat16) for p in prm]
    sprm = [p.contiguous(memory_format=cl) if p.dim() == 4 else p
            for p in sprm]
    sprm = [p.requires_grad_() for p in sprm]
    xs, gs = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)

    def k4r(backward):
        xi = x.clone().requires_grad_(backward)
        out, _ = bn_block.bn_resblock(xi, *prm, reflect=True)
        if backward:
            out.backward(g)

    def stock(backward):
        xi = xs.clone().requires_grad_(backward)
        out = stock_reflect_block(xi, *sprm)
        if backward:
            out.backward(gs)
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        times = [median_ms(lambda: f(b), 10, 3) for b in (False, True)
                 for f in (k4r, stock)]
    finally:
        torch.backends.cudnn.benchmark = bench
    print(f'K4r block {bsz}x{h}x{w}: forward {times[0]:.4f} ms (a bf16 '
          f'cuDNN reflect block, channels-last weights, benchmark mode: '
          f'{times[1]:.4f} ms); forward + backward {times[2]:.4f} ms '
          f'(cuDNN {times[3]:.4f} ms)  [{smi}]')
    return stats


def rdn_case(gen, device, bsz: int, h: int, w: int) -> tuple:
    """K6's forward inputs at the B config (x, packed dense weights,
    biases, fusion weight and bias) at srtpu's init bounds."""
    bf, f32 = torch.bfloat16, torch.float32
    c_tot = RDN_G0 * (RDN_C + 1)
    ws = [_uniform(gen, (RDN_D, 3, 3, RDN_G0 * (i + 1), RDN_G0),
                   (9 * RDN_G0 * (i + 1)) ** -0.5, device, bf)
          for i in range(RDN_C)]
    return (_uniform(gen, (bsz, h, w, RDN_G0), 1.0, device, bf), pack(ws),
            _uniform(gen, (RDN_D, RDN_C, RDN_G0), 0.05, device, f32),
            _uniform(gen, (RDN_D, c_tot, RDN_G0), c_tot ** -0.5, device, bf),
            _uniform(gen, (RDN_D, RDN_G0), c_tot ** -0.5, device, f32))


def check_rdn_kernels(device) -> dict:
    """Phase 2e. K6's forward (saving), one block's chain and its pair
    weight grads against the plain versions at the training, predict and
    ragged shapes; two calls bit-identical. Returns K6 / K6b / K6w stats,
    timed at the training shape (the forward per call of all 16 blocks,
    the chain and the weight grads per block)."""
    stats = new_stats(('K6', 'K6b', 'K6w'))
    c_tot = RDN_G0 * (RDN_C + 1)
    shapes = ((TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE),
              (1, 128, 128), (2, 67, 45))
    for i, (bsz, h, w) in enumerate(shapes):
        gen = torch.Generator().manual_seed(bsz * 7883 + h * 107 + w)
        args = rdn_case(gen, device, bsz, h, w)
        tag = f'D={RDN_D} C={RDN_C} {bsz}x{h}x{w}'
        got = rdn_fwd(*args, save=True)
        torch.cuda.synchronize()
        ref = rdn_fwd_plain(*args, save=True)
        again = rdn_fwd(*args, save=True)
        need(all(torch.equal(a, b) for a, b in zip(got, again)),
             f'K6 fwd {tag}: two calls differ')
        del again
        need(torch.equal(rdn_fwd(*args), got[0]),
             f'K6 fwd {tag}: the shared-buffer (predict) cat differs')
        err = _check_all(f'K6 rdn fwd (saving) {tag}', ('cat', 'bufs'), got,
                         ref, [K6_STEPS] * 2)
        stats['K6']['max_abs_err'] = max(stats['K6']['max_abs_err'], err)
        px = bsz * h * w
        fwd_flops = RDN_D * (RDN_PAIRS * conv_flops(px, RDN_G0, RDN_G0)
                             + 2.0 * px * c_tot * RDN_G0)
        fms = median_ms(lambda: rdn_fwd(*args, save=True), 5, 3)
        fpl = median_ms(lambda: rdn_fwd_plain(*args, save=True), 2, 3)
        nms = median_ms(lambda: rdn_fwd(*args), 5, 3)
        if i == 0:
            record(stats['K6'], fms, fpl, fwd_flops, nbytes(args, got))
        # one block's backward from the plain forward's buffers, the last
        # block (the chain's first) and the first
        bufs = ref[1]
        del got, ref
        g = _uniform(gen, (bsz, h, w, RDN_G0), 1.0, device, torch.bfloat16)
        ct = _uniform(gen, (bsz, h, w, RDN_D * RDN_G0), 1.0, device,
                      torch.bfloat16)
        wtpk = w_t(args[1]).contiguous()
        wft = args[3].transpose(1, 2).contiguous()
        for l in (RDN_D - 1, 0):
            bargs = (bufs, l, g, ct, wtpk, wft)
            bgot = rdb_bwd_chain(*bargs)
            torch.cuda.synchronize()
            bref = rdb_bwd_chain_plain(*bargs)
            need(all(torch.equal(a, b) for a, b in
                     zip(bgot, rdb_bwd_chain(*bargs))),
                 f'K6 chain {tag} block {l}: two calls differ')
            err = _check_all(f'K6 rdb_bwd_chain {tag} block {l}', K6B_STEPS,
                             bgot, bref, list(K6B_STEPS.values()))
            stats['K6b']['max_abs_err'] = max(stats['K6b']['max_abs_err'],
                                              err)
            dw = rdb_bwd_dw(bufs, l, bref[1])
            torch.cuda.synchronize()
            dw_ref = rdb_bwd_dw_plain(bufs, l, bref[1])
            need(torch.equal(dw, rdb_bwd_dw(bufs, l, bref[1])),
                 f'K6 dW {tag} block {l}: two calls differ')
            err = _check_all(f'K6 rdb_bwd_dw {tag} block {l}',
                             (f'dW ({RDN_PAIRS} pairs)',), [dw], [dw_ref],
                             [1e-4])
            stats['K6w']['max_abs_err'] = max(stats['K6w']['max_abs_err'],
                                              err)
        l = RDN_D - 1
        bargs = (bufs, l, g, ct, wtpk, wft)
        cms = median_ms(lambda: rdb_bwd_chain(*bargs), 5, 3)
        cpl = median_ms(lambda: rdb_bwd_chain_plain(*bargs), 2, 3)
        dms = median_ms(lambda: rdb_bwd_dw(bufs, l, bref[1]), 5, 3)
        dpl = median_ms(lambda: rdb_bwd_dw_plain(bufs, l, bref[1]), 2, 3)
        print(f'K6 {tag}: fwd saving kernel {fms:.4f} ms plain {fpl:.4f} ms; '
              f'fwd (predict, one buffer) kernel {nms:.4f} ms; per block: '
              f'chain kernel {cms:.4f} ms plain {cpl:.4f} ms, pair weight '
              f'grads kernel {dms:.4f} ms plain {dpl:.4f} ms')
        if i == 0:
            # the chain: the fusion's backward (dbuf and dwf, two 1x1
            # products) and the transposed convs of the 36 pairs; its
            # bytes: the block's buffer, g, ct's slice and the block's
            # weights in, dx, dout and the f32 grads out
            bwd_1x1 = 2 * 2.0 * px * c_tot * RDN_G0
            moved = (nbytes(bufs[l], g, wtpk[l], wft[l], bgot)
                     + ct.numel() * ct.element_size() // RDN_D)
            record(stats['K6b'], cms, cpl,
                   RDN_PAIRS * conv_flops(px, RDN_G0, RDN_G0) + bwd_1x1,
                   moved)
            record(stats['K6w'], dms, dpl,
                   RDN_PAIRS * conv_flops(px, RDN_G0, RDN_G0),
                   nbytes(bufs[l], bref[1], dw))
        del bufs
        torch.cuda.empty_cache()
    return stats


def check_k2_general(device, smi: str) -> dict:
    """Phase 2f. K2's general path against its plain version at every
    (c_in, c_out, k) of K2G_SHAPES, forward and backward (dx, dW, db), at
    the training, predict and ragged shapes; two calls bit-identical;
    kernel, plain and library times at the first two. Returns K2g (3x3
    forward, timed: DDBPN x4's three shapes at the predict shape), K2gb
    (3x3 backward with its weight grads, at the training shape), Wg (the
    weight grads alone, at the training shape), K2g5 (5x5 forward, at
    the predict shape) and K2g5b (5x5 backward with its weight grads, at
    the training shape: SRResNet x3's fit) stats; each error the largest
    over all shapes."""
    stats = new_stats(('K2g', 'K2gb', 'Wg', 'K2g5', 'K2g5b'))
    shapes = ((TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE),
              (1, 128, 128), (2, 67, 45))
    bf = torch.bfloat16
    for i, (bsz, h, w) in enumerate(shapes):
        for cin, cout, k in K2G_SHAPES:
            gen = torch.Generator().manual_seed(bsz * 7877 + h * 109 + w
                                                + cin * 3 + cout + k)
            x = _uniform(gen, (bsz, h, w, cin), 1.0, device, bf)
            wt = _uniform(gen, (k, k, cin, cout), (k * k * cin) ** -0.5,
                          device, bf)
            b = _uniform(gen, (cout,), 0.1, device, torch.float32)
            g = _uniform(gen, (bsz, h, w, cout), 1.0, device, bf)
            tag = f'{k}x{k} {cin}->{cout} {bsz}x{h}x{w}'
            got = conv3x3_fwd(x, wt, b)
            torch.cuda.synchronize()
            ref = conv3x3_plain(x, wt, b)
            need(torch.equal(got, conv3x3_fwd(x, wt, b)),
                 f'K2 general fwd {tag}: two calls differ')
            e_f = _check_all(f'K2 general fwd {tag}', ('y',), [got], [ref],
                             [TOL_STEPS['K2']])
            bgot = conv3x3_bwd(x, wt, g)
            torch.cuda.synchronize()
            bref = conv3x3_bwd_plain(x, wt, g)
            need(all(torch.equal(a, c) for a, c in
                     zip(bgot, conv3x3_bwd(x, wt, g))),
                 f'K2 general bwd {tag}: two calls differ')
            e_b = _check_all(f'K2 general bwd {tag} (dx {cout}->{cin})',
                             ('dx', 'dW', 'db'), bgot, bref,
                             [BWD_DX_STEPS['K2'], 1e-4, 1e-4])
            errs = {'K2g' if k == 3 else 'K2g5': e_f,
                    'K2gb' if k == 3 else 'K2g5b': e_b,
                    'Wg': _err(bgot[1], bref[1], None)[0]}
            for key, e in errs.items():
                stats[key]['max_abs_err'] = max(stats[key]['max_abs_err'], e)
            if i == 2:
                continue
            px = bsz * h * w
            t = {name: median_ms(fn, 10, 3) for name, fn in (
                ('fwd', lambda: conv3x3_fwd(x, wt, b)),
                ('fwd_plain', lambda: conv3x3_plain(x, wt, b)),
                ('fwd_lib', lib_conv(x, wt, b)),
                ('bwd', lambda: conv3x3_bwd(x, wt, g)),
                ('bwd_plain', lambda: conv3x3_bwd_plain(x, wt, g)),
                ('bwd_lib', lib_conv_bwd(x, wt, g)),
                ('w', lambda: conv_wgrad(x, g, k=k)),
                ('w_plain', lambda: conv_wgrad_plain(x, g, k=k)),
                ('w_lib', lib_wgrad(x[None], g[None], k)))}
            f_fl = conv_flops(px, cin, cout, k)
            print(f'K2 general {tag}: fwd kernel {t["fwd"]:.4f} ms plain '
                  f'{t["fwd_plain"]:.4f} lib {t["fwd_lib"]:.4f} (bound '
                  f'{max(bound(f_fl, nbytes(x, wt, b, got))):.5f}); bwd '
                  f'kernel {t["bwd"]:.4f} plain {t["bwd_plain"]:.4f} lib '
                  f'{t["bwd_lib"]:.4f} (bound '
                  f'{max(bound(2 * f_fl, nbytes(x, wt, g, bgot))):.5f}); '
                  f'weight grads kernel {t["w"]:.4f} plain '
                  f'{t["w_plain"]:.4f} lib {t["w_lib"]:.4f} (bound '
                  f'{max(bound(f_fl, nbytes(x, g, bgot[1:]))):.5f})  [{smi}]')
            if (cin, cout, k) in K2G_X4 and i == 1:
                stats['K2g']['library_ms'] = (stats['K2g']['library_ms']
                                              or 0.0) + t['fwd_lib']
                record(stats['K2g'], t['fwd'], t['fwd_plain'], f_fl,
                       nbytes(x, wt, b, got))
            if (cin, cout, k) in K2G_X4 and i == 0:
                for key, pre, fl, moved in (
                        ('K2gb', 'bwd', 2 * f_fl, nbytes(x, wt, g, bgot)),
                        ('Wg', 'w', f_fl, nbytes(x, g, bgot[1:]))):
                    stats[key]['library_ms'] = (stats[key]['library_ms']
                                                or 0.0) + t[pre + '_lib']
                    record(stats[key], t[pre], t[pre + '_plain'], fl, moved)
            if k == 5 and i == 1:
                stats['K2g5']['library_ms'] = t['fwd_lib']
                record(stats['K2g5'], t['fwd'], t['fwd_plain'], f_fl,
                       nbytes(x, wt, b, got))
            if k == 5 and i == 0:
                stats['K2g5b']['library_ms'] = t['bwd_lib']
                record(stats['K2g5b'], t['bwd'], t['bwd_plain'], 2 * f_fl,
                       nbytes(x, wt, g, bgot))
        torch.cuda.empty_cache()
    return stats


def wdsr_case(gen, device, bsz: int, h: int, w: int) -> tuple:
    """K7's operands at WDSR-B's width (C 128, e 768, L 102 padded to Lp
    112 with zero rows) at srtpu's init bounds, and a cotangent g."""
    bf, f32 = torch.bfloat16, torch.float32
    c, e, lv, lp = WDSR_C, WDSR_E, WDSR_LV, WDSR_LP

    def padded(t, dim):
        return F.pad(t, (0, 0) * (t.dim() - 1 - dim) + (0, lp - lv))
    return (_uniform(gen, (bsz, h, w, c), 1.0, device, bf),
            _uniform(gen, (c, e), c ** -0.5, device, bf),
            _uniform(gen, (e,), c ** -0.5, device, f32),
            padded(_uniform(gen, (e, lv), e ** -0.5, device, bf), 1),
            padded(_uniform(gen, (lv,), e ** -0.5, device, f32), 0),
            padded(_uniform(gen, (3, 3, lv, c), (9 * lv) ** -0.5, device,
                            bf), 2).contiguous(),
            _uniform(gen, (c,), (9 * lv) ** -0.5, device, f32),
            _uniform(gen, (bsz, h, w, c), 1.0, device, bf))


def stock_block(x, w1, b1, w2, b2, w3, b3, res_scale: float = 1.0):
    """One WDSR-B block on the stock route, cuDNN in bf16 channels-last:
    1x1, ReLU, 1x1, 3x3, x res_scale, + x. x is NHWC (its NCHW view goes
    in), the weights OIHW in channels-last memory and the biases bf16
    (stock_operands), as lib_conv's."""
    xc = x.permute(0, 3, 1, 2)
    h = F.conv2d(xc, w1, b1).relu()
    h = F.conv2d(h, w2, b2)
    return F.conv2d(h, w3, b3, padding=1) * res_scale + xc


def stock_operands(x, w1, b1, w2, b2, w3, b3) -> list:
    """stock_block's leaves from K7's unpadded operands (w1 (C, e), w2
    (e, L), w3 HWIO (3, 3, L, C)): weights OIHW channels-last, biases in
    x's dtype, each a leaf that takes a gradient."""
    cl = torch.channels_last

    def oihw(w):
        w = w.t()[:, :, None, None] if w.dim() == 2 else w.permute(3, 2, 0, 1)
        return w.contiguous(memory_format=cl)
    return [t.detach().clone().requires_grad_() if t is x else
            t.detach().requires_grad_() for t in
            (x, oihw(w1), b1.to(x.dtype), oihw(w2), b2.to(x.dtype), oihw(w3),
             b3.to(x.dtype))]


def check_wdsr_kernels(device, smi: str) -> dict:
    """Phase 2g. K7's forward and backward against the plain versions at
    the training shape (batch 16, LR 32x32), the predict shape (batch 1,
    128x128) and a ragged batch 2 of 67x45, C = 128, res_scale 1 (srtpu's
    default): every output beside its tolerance, two calls bit-identical,
    kernel and plain times, the bound; and one stock-route block (cuDNN)
    timed beside, each way. Returns K7 / K7b stats, timed at the training
    shape (per block)."""
    stats = new_stats(('K7', 'K7b'))
    shapes = ((TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE),
              (1, 128, 128), (2, 67, 45))
    for i, (bsz, h, w) in enumerate(shapes):
        gen = torch.Generator().manual_seed(bsz * 7907 + h * 113 + w)
        x, *prm, g = wdsr_case(gen, device, bsz, h, w)
        fargs, bargs = (x, *prm, 1.0), (x, g, *prm[:5], 1.0)
        tag = f'C={WDSR_C} e={WDSR_E} Lp={WDSR_LP} {bsz}x{h}x{w}'
        got = wdsr_fwd(*fargs)
        torch.cuda.synchronize()
        ref = wdsr_fwd_plain(*fargs)
        need(torch.equal(got, wdsr_fwd(*fargs)),
             f'K7 fwd {tag}: two calls differ')
        err = _check_all(f'K7 wdsr fwd {tag}', K7_STEPS, [got], [ref],
                         list(K7_STEPS.values()))
        stats['K7']['max_abs_err'] = max(stats['K7']['max_abs_err'], err)
        bgot = wdsr_bwd(*bargs)
        torch.cuda.synchronize()
        bref = wdsr_bwd_plain(*bargs)
        need(all(torch.equal(a, b) for a, b in zip(bgot, wdsr_bwd(*bargs))),
             f'K7 bwd {tag}: two calls differ')
        err = _check_all(f'K7 wdsr bwd {tag}', K7B_STEPS, bgot, bref,
                         list(K7B_STEPS.values()))
        stats['K7b']['max_abs_err'] = max(stats['K7b']['max_abs_err'], err)
        if i == 2:
            continue
        # the function's work and bytes at the bottleneck width L (the
        # padding to Lp is the kernels' choice): wdsr_cs.py:154 (forward)
        # and :193 (backward, twice the work) at L
        px, lv = bsz * h * w, WDSR_LV
        fwd_flops = 2.0 * px * (WDSR_E * WDSR_C + lv * WDSR_E
                                + 9 * WDSR_C * lv)
        fun = (x, prm[0], prm[1], prm[2][:, :lv], prm[3][:lv],
               prm[4][:, :, :lv], prm[5])
        fms = median_ms(lambda: wdsr_fwd(*fargs), 10, 3)
        fpl = median_ms(lambda: wdsr_fwd_plain(*fargs), 3, 3)
        bms = median_ms(lambda: wdsr_bwd(*bargs), 10, 3)
        bpl = median_ms(lambda: wdsr_bwd_plain(*bargs), 3, 3)
        f_moved = nbytes(fun, got)
        b_moved = nbytes(g, fun[:6], bgot[:3], bgot[3][:, :lv],
                         bgot[4][:lv], bgot[5][:, :, :lv], bgot[6])
        f_bound = max(bound(fwd_flops, f_moved))
        b_bound = max(bound(2 * fwd_flops, b_moved))
        # the stock route's block, forward and forward + backward, with
        # cuDNN's benchmark mode on (its fastest algorithms)
        sw = stock_operands(*fun)
        gc = g.permute(0, 3, 1, 2)
        bench_mode = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        with torch.no_grad():
            sms = median_ms(lambda: stock_block(*sw), 10, 3)
        sbms = median_ms(lambda: torch.autograd.grad(
            stock_block(*sw), sw, gc), 10, 3)
        torch.backends.cudnn.benchmark = bench_mode
        print(f'K7 {tag}: fwd kernel {fms:.4f} ms plain {fpl:.4f} ms bound '
              f'{f_bound:.5f} ms; bwd (incl. dW3 / db3) kernel {bms:.4f} ms '
              f'plain {bpl:.4f} ms bound {b_bound:.5f} ms  [{smi}]')
        print(f'K7 {tag}: stock route, one block on cuDNN (1x1, ReLU, 1x1, '
              f'3x3, x res_scale + x; bf16, activations and weights '
              f'channels-last, benchmark mode): fwd {sms:.4f} ms, fwd + bwd '
              f'{sbms:.4f} ms (a reference, not library_ms: no single '
              f'PyTorch call computes the block)  [{smi}]')
        if i == 0:
            record(stats['K7'], fms, fpl, fwd_flops, f_moved)
            record(stats['K7b'], bms, bpl, 2 * fwd_flops, b_moved)
        del got, ref, bgot, bref, sw
        torch.cuda.empty_cache()
    return stats


def png_size(path: Path) -> tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk."""
    head = path.read_bytes()[:24]
    need(head[:8] == b'\x89PNG\r\n\x1a\n' and head[12:16] == b'IHDR',
         f'{path} is not a PNG')
    w, h = struct.unpack('>II', head[16:24])
    return h, w


def run_slice(device, smi: str, model: str = 'EDSR', extra=(),
              expected=EXPECTED_LAUNCHES, rules=None, scale: int = SCALE,
              sizes=SLICE_SIZES, alt=(), profile_all: bool = False) -> dict:
    """Phase 3 (EDSR) and 5, 7, 9, 11, 13, 14 (``extra`` the model's CLI
    flags): predict at ``scale`` through the CLI on images of ``sizes``,
    the launch counters per image (``expected``), the PNGs, kernel path
    against plain path; with ``rules``, device time by kernel group of
    the largest image's forward (``profile_all``: each image's, with the
    largest unmatched kernels); with ``alt`` (flags of another route of
    the same model and weights), that route's forward time per image
    beside. Returns the launch counts of the main-path run."""
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory(prefix='srtpu_smoke_') as tmp:
        demo = Path(tmp) / 'datasets' / 'Demo'
        demo.mkdir(parents=True)
        images = {}
        for h, w in sizes:
            lo = rng.random((h // 8 + 1, w // 8 + 1, 3))
            img = np.kron(lo, np.ones((8, 8, 1)))[:h, :w] * 0.8 \
                + rng.random((h, w, 3)) * 0.2
            name = f'img{h}x{w}'
            images[name] = img.astype(np.float32)
            np.save(demo / f'{name}.npy', images[name])
        argv = ['predict', '--model', model, '--scale_factor', str(scale),
                '--n_feats', str(C), '--n_resblocks', str(L), *extra,
                '--datasets_dir', str(Path(tmp) / 'datasets'),
                '--predict_datasets', 'Demo', '--precision', 'bf16',
                '--device', 'cuda', '--seed', str(SEED)]
        warm = argv + ['--default_root_dir', str(Path(tmp) / 'warm')]
        need(cli.main(warm) == 0, 'warm-up predict')   # cuDNN plans, allocator
        out = Path(tmp) / 'out'
        for k in expected:
            setattr(*_counter(k), 0)
        t0 = time.perf_counter()
        rc = cli.main(argv + ['--default_root_dir', str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: getattr(*_counter(k)) for k in expected}
        need(rc == 0, f'predict returned {rc}')
        for k, per_image in expected.items():
            need(counts[k] == per_image * len(images),
                 f'{_counter_name(k)}: {counts[k]} launches, expected '
                 f'{per_image} x {len(images)}')
        for name, img in images.items():
            size = png_size(out / 'Demo' / f'{name}.png')
            need(size == (scale * img.shape[0], scale * img.shape[1]),
                 f'{name}.png is {size}')
        mpix = sum(scale * scale * img.shape[0] * img.shape[1]
                   for img in images.values()) / 1e6
        print(f'{model} x{scale} predict CLI (incl. PNG encode + write): '
              f'{len(images)} images '
              f'in {wall:.3f} s = {len(images) / wall:.3f} images/s, '
              f'{mpix / wall:.3f} MPix/s  [{smi}]')

        # eval mode, as the CLI's predict (SRResNet's batch norm)
        net = cli.build_model(cli.build_parser().parse_args(argv),
                              device).eval()
        net_alt = cli.build_model(cli.build_parser().parse_args(
            argv + list(alt)), device).eval() if alt else None
        for name, img in images.items():
            lr = torch.from_numpy(pad_to_bucket(img, 32)[0][None]).to(device)
            h, w = scale * img.shape[0], scale * img.shape[1]
            with torch.inference_mode():
                sr_k = net(lr).float().clamp(0, 1)[0, :h, :w]
                sr_p = net(lr, plain=True).float().clamp(0, 1)[0, :h, :w]
                ms = median_ms(lambda: net(lr), launches=1)
                plain_ms = median_ms(lambda: net(lr, plain=True),
                                     launches=1)
            need(sr_k.shape == (h, w, 3) and bool(torch.isfinite(sr_k).all()),
                 f'{name}: SR shape {tuple(sr_k.shape)} or non-finite')
            diff = (sr_k - sr_p).abs()
            err, mean = diff.max().item(), diff.mean().item()
            print(f'{model} x{scale} slice {name} '
                  f'(LR {tuple(lr.shape[1:3])}): '
                  f'max_abs {err:.4g}'
                  f' (tol {SLICE_MAX_TOL:.4g}) mean_abs {mean:.3g} (tol '
                  f'{SLICE_MEAN_TOL:.3g}) | forward kernels {ms:.3f} ms = '
                  f'{1e3 / ms:.2f} images/s, {h * w / ms / 1e3:.2f} MPix/s; '
                  f'plain {plain_ms:.3f} ms  [{smi}]')
            need(err <= SLICE_MAX_TOL and mean <= SLICE_MEAN_TOL,
                 f'{name}: kernel path vs plain path')
            if rules and profile_all:
                with torch.inference_mode():
                    _profile(lambda: net(lr), ms, smi, rules,
                             f'{model} predict forward, LR '
                             f'{tuple(lr.shape[1:3])}', top=6)
            if net_alt is not None:
                with torch.inference_mode():
                    sr_a = net_alt(lr).float().clamp(0, 1)[0, :h, :w]
                    alt_ms = median_ms(lambda: net_alt(lr), launches=1)
                print(f'{model} x{scale} slice {name}, {" ".join(alt)} '
                      f'(same weights): forward {alt_ms:.3f} ms = '
                      f'{1e3 / alt_ms:.2f} images/s (kernel route '
                      f'{ms:.3f} ms); max_abs vs the kernel route '
                      f'{(sr_a - sr_k).abs().max().item():.4g}  [{smi}]')
            # the CLI's PNG is this checked SR image, saved the same way
            check = Path(tmp) / 'check.png'
            save_image(sr_k.cpu().numpy(), check)
            need(check.read_bytes() ==
                 (out / 'Demo' / f'{name}.png').read_bytes(),
                 f'{name}.png differs from the checked kernel-path SR')
        if rules and not profile_all:
            with torch.inference_mode():
                _profile(lambda: net(lr), ms, smi, rules,
                         f'{model} predict forward, LR {tuple(lr.shape[1:3])}')
                if net_alt is not None:
                    _profile(lambda: net_alt(lr), alt_ms, smi, rules,
                             f'{model} predict forward, {" ".join(alt)}, '
                             f'LR {tuple(lr.shape[1:3])}')
    return counts


class _LossLog(logging.Handler):
    """Collects the losses of each ``epoch %d/%d  loss %.4f ...`` record:
    ``losses`` the first (the loss; an SRGAN's g_loss), ``rows`` all
    (an SRGAN's g_loss, d_loss)."""

    def __init__(self):
        super().__init__()
        self.losses: list[float] = []
        self.rows: list[tuple] = []

    def emit(self, record):
        if record.msg.startswith('epoch '):
            self.rows.append(tuple(float(a) for a in record.args[2:-1]))
            self.losses.append(self.rows[-1][0])


# kernel-name substring -> group of the profile, first match wins
EDSR_PROFILE = (('resblock_bwd_kernel', 'K1 bwd dx chain'),
                ('resblock_kernel', 'K1 fwd'), ('wgrad', 'weight grads'),
                ('conv3x3_kernel<64, 64, 7, 16, true', 'K3 fwd'),
                ('conv3x3_kernel<256, 16, 7, 16, false, true', 'K3 bwd dx'),
                ('conv3x3_kernel', 'K2 fwd + bwd dx'))
RCAN_PROFILE = (('rcab_pair_kernel', 'K5 fwd conv pair (F1)'),
                ('rcab_pool_mlp_kernel', 'K5 fwd pool + MLP (F2)'),
                ('rcab_gate_kernel', 'K5 fwd gate (F3)'),
                ('rcab_ca_sums_kernel', 'K5 bwd pool sums (B1)'),
                ('rcab_ca_bwd_kernel', 'K5 bwd MLP (B2)'),
                ('rcab_mlp_grads_kernel', 'K5 bwd MLP (B2)'),
                ('rcab_dr2_kernel', 'K5 bwd dr2 (B3)'),
                ('rcab_chain_kernel', 'K5 bwd dx chain (B4)'),
                ('wgrad', 'weight grads'),
                ('conv3x3_kernel', 'K2 fwd + bwd dx'))
SRRESNET_PROFILE = (
    ('bn_conv_stats_kernel<false', 'K4 F1 conv + stats'),
    ('bn_conv_stats_kernel<true', 'K4 F2 norm + PReLU + conv + stats'),
    ('bn_norm_skip_kernel', 'K4 F3 norm + skip'),
    ('bn_sums_kernel', 'K4 B1 sums'),
    ('bn_bwd_conv_kernel<true', 'K4 B2 BN2 bwd + convT + PReLU bwd'),
    ('bn_bwd_conv_kernel<false', 'K4 B3 BN1 bwd + convT + skip'),
    ('bn_reduce_kernel', 'K4 fixed-order reductions + finalize'),
    ('wgrad', 'weight grads'),
    ('conv3x3_kernel<64, 64, 7, 16, true', 'K3 fwd'),
    ('conv3x3_kernel<256, 16, 7, 16, false, true', 'K3 bwd dx'),
    ('conv3x3_kernel<256, 16, 6, 16', 'K2 5x5 fwd'),
    ('conv3x3_kernel<16, 64, 6, 16', 'K2 5x5 bwd dx'),
    ('conv3x3_kernel', 'K2 3x3 fwd + bwd dx'))
RDN_PROFILE = (('rdn_dense_kernel', 'K6 fwd dense layers'),
               ('rdn_lff_kernel', 'K6 fwd fusion'),
               ('rdn_copy_in_kernel', 'K6 fwd copy-in'),
               ('rdn_lff_bwd_kernel', 'K6b fusion bwd'),
               ('rdn_chain_kernel', 'K6b dx chain'),
               ('rdn_dw_kernel<1', 'K6b dwf'),
               ('rdn_dw_kernel<3', 'K6w pair weight grads'),
               ('rdn_reduce', 'K6 fixed-order reductions'),
               ('wgrad', 'weight grads (K2)'),
               ('conv3x3_kernel', 'K2 fwd + bwd dx'))
DDBPN_PROFILE = (
    ('conv_chunked_kernel<32, 64', 'K2 32->512 (up fwd, down dx)'),
    ('conv_chunked_kernel<64, 32', 'K2 512->32 (down fwd, up dx)'),
    ('conv_chunked_kernel<64, 16', 'K2 512->48 (output conv fwd)'),
    ('conv_chunked_kernel<16, 64', 'K2 48->512 (output conv dx)'),
    ('wgrad_chunk_kernel', 'weight grads (general path)'),
    ('wgrad_reduce', 'weight grads fixed-order reductions'),
    ('gemm', '1x1 bottlenecks and head (cuBLAS)'),
    ('nvjet', '1x1 bottlenecks and head (cuBLAS)'))
WDSR_PROFILE = (
    ('wdsr_pw_fwd_kernel', 'K7 fused 1x1 pair -> h2 (h1 in shared memory)'),
    ('Dh2Out', 'K7b dh2 = convT(gs)'),
    ('ScaleSkipOut', 'K7 3x3 + res_scale + skip'),
    ('wdsr_pw_bwd_kernel', 'K7b fused pointwise bwd (h1 recomputed; dx, '
     'dW1, dW2)'),
    ('wdsr_reduce', 'K7b fixed-order reductions'),
    ('wgrad_chunk_kernel', 'K7b dW3, db3 (weight-grad kernel)'),
    ('wgrad_reduce', 'K7b dW3, db3 reductions'),
    ('fprop', 'stock route: cuDNN conv forward'),
    ('dgrad', 'stock route: cuDNN conv dx'),
    ('wgrad', 'stock route: cuDNN conv dW'),
    ('gemm', 'GEMMs (cuBLAS / cuDNN 1x1)'),
    ('nvjet', 'GEMMs (cuBLAS / cuDNN 1x1)'))
SRRESNET_X3_PROFILE = (
    ('conv_chunked_kernel', 'K2 general path (x3 phase-dense 5x5, dx)'),
    ('wgrad_chunk_kernel', 'weight grads, general path (5x5 576->32)'),
    *SRRESNET_PROFILE)
SRGAN_PROFILE = (
    ('bn_fold_ring_kernel', 'K4r B2 / B3 fold ring'),
    ('bn_conv_stats_kernel<false, true', 'K4r F1 conv + stats'),
    ('bn_conv_stats_kernel<true, true', 'K4r F2 norm + PReLU + conv + '
     'stats'),
    ('bn_bwd_conv_kernel<true, true', 'K4r B2 BN2 bwd + convT + fold + '
     'PReLU bwd'),
    ('bn_bwd_conv_kernel<false, true', 'K4r B3 BN1 bwd + convT + fold + '
     'skip'),
    ('bn_norm_skip_kernel', 'K4 F3 norm + skip'),
    ('bn_sums_kernel', 'K4 B1 sums'),
    ('bn_reduce_kernel', 'K4 fixed-order reductions + finalize'),
    ('wgrad_kernel<', 'K4r weight grads (reflect)'),
    ('wgrad_reduce', 'K4r weight grads (reflect)'),
    ('multi_tensor_apply', 'Adam (G and D)'))
# SRGAN predict: eval mode, stock PyTorch only (f32 cuDNN convs on
# bf16-rounded inputs, TF32 off as set above)
SRGAN_PREDICT_PROFILE = (
    ('reflection_pad', 'reflect pads'),
    ('fft', 'cuDNN convs (FFT)'),
    ('winograd', 'cuDNN convs (Winograd)'),
    ('fprop', 'cuDNN convs (implicit GEMM)'),
    ('convolve', 'cuDNN convs (implicit GEMM)'),
    ('elementwise', 'elementwise (casts, BN apply, PReLU, adds, tanh)'))
OTHER = 'other (cuDNN head/tail, Adam, casts, copies)'


def _device_us(prof, names=None) -> dict:
    """Device time (µs) by kernel name from a finished torch.profiler run,
    of the kernels whose names contain one of ``names`` (all if None)."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if names is not None and not any(n in e.key for n in names):
            continue
        us = getattr(e, 'self_device_time_total', None)
        out[e.key] = us if us is not None else e.self_cuda_time_total
    return out


def _kernel_device_ms(run, names, calls: int = 10) -> float:
    """Device time per call of ``run`` (torch.profiler, ``calls`` calls)
    of the kernels whose names contain one of ``names``: a kernel's own
    time, without its wrapper's other launches (a transposed weight's
    copy) or host work."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    us = sum(_device_us(prof, names).values())
    need(us > 0, f'profiler: no device time for {names}')
    return us / 1e3 / calls


def _profile(run, ms: float, smi: str, rules, what: str,
             top: int = 0) -> None:
    """Device time by kernel group (``rules``) over three calls of
    ``run`` (torch.profiler), and its share of ``ms``, the call's time
    measured without the profiler (whose own host cost inflates the
    traced wall time); with ``top``, that many of the largest kernels of
    the unmatched group by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 3
    groups = {key: 0.0 for _, key in rules}
    groups[OTHER] = 0.0
    other = {}
    for name, us in _device_us(prof).items():
        key = next((k for sub, k in rules if sub in name), OTHER)
        groups[key] += us / 1e3 / 3
        if key == OTHER:
            other[name] = us / 1e3 / 3
    device = sum(groups.values())
    if device == 0.0:
        print('profiler: no device time recorded')
        return
    print(f'{what} device time by kernel (torch.profiler, 3 calls): '
          f'device {device:.3f} ms = {device / ms:.3f} of the {ms:.3f} ms '
          f'call (traced wall {wall:.3f} ms)  [{smi}]')
    for key, t in groups.items():
        print(f'  {key}: {t:.3f} ms ({t / device:.3f})')
    for name, t in sorted(other.items(), key=lambda kv: -kv[1])[:top]:
        print(f'    {t:.3f} ms  {name[:110]}')


def _grads(m) -> dict:
    return {n: p.grad for n, p in m.named_parameters()}


def _grads_vs_plain(model: str, net, lr, hr, paths) -> None:
    """EDSR's and RCAN's train step gradients, kernel path against plain
    path from identical params and batch: within STEP_GRAD_TOL of the
    largest magnitude (RCAN's attention MLP: MLP_STEP_GRAD_TOL)."""
    rels = {False: {}, True: {}}     # by: is an attention MLP
    for (name, pk), pp in zip(paths[False][1].model.named_parameters(),
                              paths[True][1].model.parameters()):
        need(pk.grad.dtype == torch.float32, f'{name} grad dtype')
        rels[name.endswith(MLP_PARAMS)][name] = (
            (pk.grad - pp.grad).abs().max() / pp.grad.abs().max()).item()
    for mlp, tol in ((False, STEP_GRAD_TOL), (True, MLP_STEP_GRAD_TOL)):
        if not rels[mlp]:
            continue
        top = sorted(rels[mlp].items(), key=lambda kv: -kv[1])
        print(f'{model} train step, kernel vs plain path: worst '
              f'{"attention-MLP " if mlp else ""}gradients max_abs/max|ref| '
              + ', '.join(f'{n} {v:.4g}' for n, v in top[:4])
              + f' (tol {tol:.4g})')
        need(top[0][1] <= tol, f'{top[0][0]} gradient')


def _grads_vs_f32(model: str, net, lr, hr, paths) -> None:
    """SRResNet's train step gradients, held to an f32 step (_vs_f32),
    and each block's BN2 backward dy with them (_dy_rows, from a rerun of
    the first step's kernel and plain paths: the same params and batch):
    through 16 batch norms the kernel and plain bf16 paths part by more
    than a few rounding steps. Then a kernel step with each planted fault
    (PLANTED), from the same params and batch, must fail that check."""
    def step(m, plain, rec):
        with _dy_record(bn_block.PLAIN if plain else bn_block.KERNELS, rec):
            make_train_step(parse_losses('l1'), plain=plain)(TrainState(
                m, build_optimizer('ADAM', ['lr=1e-4'], m.parameters())),
                lr, hr)
        return m

    m32 = copy.deepcopy(net)
    m32.dtype = None                     # f32 compute, no rounding
    scales, rk, rp, rf = {}, [], [], []
    with _db_scales(scales, 'trunk.'):
        step(m32, True, rf)
    step(copy.deepcopy(net), False, rk)
    step(copy.deepcopy(net), True, rp)
    gk, gp, gf = (_grads(m) for m in (paths[False][1].model,
                                       paths[True][1].model, m32))
    for n, t in gk.items():
        need(t.dtype == torch.float32, f'{n} grad dtype')
    rows = _vs_f32(gk, gp, gf, scales)
    dy_rows = _dy_rows(rk, rp, rf)
    label = f'{model} train step gradients'
    need(all(r <= 1.0 for r, _ in rows + dy_rows),
         f'{label}: ' + '; '.join(t for r, t in rows + dy_rows
                                  if not r <= 1.0))
    print(f'{label}, max_abs vs the f32 step, kernel/plain/tol (|f32|), '
          f'the four nearest their tolerance: '
          + ', '.join(t for _, t in rows[:4]) + '; the pre-BN biases: '
          + ', '.join(t for _, t in rows if '|grad|' in t)
          + '; per block, error/limit: '
          + ', '.join(f'{t} = {r:.4g}' for r, t in dy_rows))
    for what, fault in PLANTED.items():
        bad_dy = []
        with _planted(fault):
            m = step(copy.deepcopy(net), False, bad_dy)
        _catches(_vs_f32(_grads(m), gp, gf, scales)
                 + _dy_rows(bad_dy, rp, rf), what, label)


def _grads_ddbpn(model: str, net, lr, hr, paths) -> None:
    """DDBPN's train step gradients, kernel path against plain path
    (_grads_vs_plain), and every dead-tap slot's gradient on the kernel
    path exactly 0 (each projection weight against its mask, the output
    conv's against its own), with the live slots' not all 0."""
    _grads_vs_plain(model, net, lr, hr, paths)
    m = paths[False][1].model
    masks = {True: m.m_up, False: m.m_down}
    dead = live = 0
    for i, unit in enumerate(m.units):
        for name, is_up in (('a0', unit.up), ('b0', not unit.up),
                            ('a1', unit.up)):
            gr, mask = getattr(unit, f'{name}_weight').grad, masks[is_up]
            need(bool((gr[mask == 0] == 0).all()),
                 f'units.{i}.{name}: a dead-tap slot has a gradient')
            dead += int((mask == 0).sum())
            live += int((gr[mask != 0] != 0).sum())
    gr = m.out_weight.grad
    need(bool((gr[:, m.m_out == 0] == 0).all()),
         'out_weight: a dead-tap slot has a gradient')
    dead += int((m.m_out == 0).sum()) * gr.shape[0]
    need(live > 0, 'no live projection weight got a gradient')
    print(f'{model} train step: all {dead} dead-tap weight slots have '
          f'gradient exactly 0 on the card; {live} live slots nonzero')


def fit_data(root: Path, scale: int, patch: int) -> Path:
    """A synthetic training set of TRAIN_BATCH smooth-plus-noise .npy HR
    images of 1.5 patches (one step per epoch) and their box-filtered LR
    at ``scale``, drawn from SEED; returns its datasets directory."""
    rng = np.random.default_rng(SEED)
    hr_size = 3 * patch // 2
    data = root / 'datasets'
    hr_dir = data / 'Train' / 'HR'
    lr_dir = data / 'Train' / 'LR' / f'X{scale}'
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    for i in range(TRAIN_BATCH):
        lo = rng.random((hr_size // 8, hr_size // 8, 3))
        hr = (np.kron(lo, np.ones((8, 8, 1))) * 0.8
              + rng.random((hr_size, hr_size, 3)) * 0.2).astype(np.float32)
        np.save(hr_dir / f'{i:02d}.npy', hr)
        lr = hr.reshape(hr_size // scale, scale, hr_size // scale, scale,
                        3).mean((1, 3))
        np.save(lr_dir / f'{i:02d}.npy', lr.astype(np.float32))
    return data


def fit_batches(data: Path, scale: int, patch: int, device, n: int = 5):
    """The first batch of each of ``n`` epochs of the fit loader (seed
    SEED), on the device: the batches the CLI's fit trained on."""
    from srtpu_torch.data import SRData
    dm = SRData(datasets_dir=str(data), train_datasets=['Train'],
                batch_size=TRAIN_BATCH, patch_size=patch,
                scale_factor=scale, seed=SEED)
    dm.setup('fit')
    loader = dm.train_loader()
    batches = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        b = next(iter(loader))
        batches.append((torch.from_numpy(b.lr).to(device),
                        torch.from_numpy(b.hr).to(device)))
    return batches


def run_train(device, smi: str, model: str = 'EDSR', extra=(),
              expected=STEP_LAUNCHES, rules=EDSR_PROFILE,
              compare=_grads_vs_plain, scale: int = SCALE,
              patch: int = TRAIN_PATCH, steps: int = TRAIN_STEPS,
              alt=()) -> dict:
    """Phase 4 (EDSR), 6 (RCAN), 8 (SRResNet), 10, 12, 15 and 16
    (``extra`` the model's CLI flags): fit through the CLI at ``scale``
    on ``patch`` HR patches for ``steps`` steps, the launch counters per
    step (``expected``), the loss, the first kernel-path and plain-path
    steps' gradients (``compare``), five steps' losses, step times (with
    ``alt``, flags of another route of the same model, that route's step
    time from the same params beside), the profile. Returns the launch
    counts of the fit run."""
    with tempfile.TemporaryDirectory(prefix='srtpu_smoke_fit_') as tmp:
        data = fit_data(Path(tmp), scale, patch)
        argv = ['fit', '--model', model, '--scale_factor', str(scale),
                '--n_feats', str(C), '--n_resblocks', str(L), *extra,
                '--datasets_dir', str(data), '--train_datasets', 'Train',
                '--batch_size', str(TRAIN_BATCH), '--patch_size',
                str(patch), '--losses', 'l1', '--optimizer', 'ADAM',
                '--optimizer_params', 'lr=1e-4', '--max_epochs',
                str(steps), '--precision', 'bf16', '--device', 'cuda',
                '--seed', str(SEED), '--default_root_dir',
                str(Path(tmp) / 'run')]
        log = _LossLog()
        logging.getLogger('srtpu_torch.train.loop').addHandler(log)
        for k in expected:
            setattr(*_counter(k), 0)
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: getattr(*_counter(k)) for k in expected}
        logging.getLogger('srtpu_torch.train.loop').removeHandler(log)
        need(rc == 0, f'fit returned {rc}')
        for k, per_step in expected.items():
            need(counts[k] == per_step * steps,
                 f'{_counter_name(k)}: {counts[k]} launches in fit, '
                 f'expected {per_step} x {steps}')
        losses = log.losses
        need(len(losses) == steps and all(map(np.isfinite, losses)),
             f'fit losses {losses}')
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f'{model} x{scale} fit CLI: {steps} steps in {wall:.3f} s '
              f'(incl. model '
              f'init, .npy reads, batching, logs); losses '
              + ' '.join(f'{v:.4f}' for v in losses)
              + f'; mean first 5 {first:.5f} last 5 {last:.5f}  [{smi}]')
        need(last < first, 'the fit loss did not fall')
        need((Path(tmp) / 'run' / 'final_weights.pt').is_file(),
             'fit wrote no final_weights.pt')
        saved = torch.load(Path(tmp) / 'run' / 'final_weights.pt',
                           weights_only=True)
        for name in (k for k in saved if '.mean' in k or '.var' in k):
            t, init = saved[name].float(), float('.var' in name)
            need(bool(torch.isfinite(t).all()) and bool((t != init).any()),
                 f'{name}: running statistics not finite or never moved')
            print(f'{model} fit: {name} finite, moved from {init}: mean '
                  f'{t.mean().item():.4g}')

        # kernel path vs plain path from the same params and batches
        net = cli.build_model(cli.build_parser().parse_args(argv), device)
        batches = fit_batches(data, scale, patch, device)
        paths = {}
        for plain in (False, True):
            m = copy.deepcopy(net)
            paths[plain] = (make_train_step(parse_losses('l1'), plain=plain),
                            TrainState(m, build_optimizer(
                                'ADAM', ['lr=1e-4'], m.parameters())))
        step_losses = {False: [], True: []}
        for j, (lr, hr) in enumerate(batches):
            for plain, (step, state) in paths.items():
                step_losses[plain].append(float(step(state, lr, hr)['loss']))
            if j == 0:      # gradients from identical params and batch
                compare(model, net, lr, hr, paths)
        rels = [abs(a - b) / b for a, b in zip(step_losses[False],
                                               step_losses[True])]
        print(f'{model} train losses kernel / plain: ' + ' '.join(
            f'{a:.5f}/{b:.5f}' for a, b in zip(step_losses[False],
                                               step_losses[True]))
            + f'; max rel {max(rels):.4g} (tol {STEP_LOSS_TOL:.4g})')
        need(max(rels) <= STEP_LOSS_TOL, 'kernel vs plain path losses')
        lr, hr = batches[0]
        labels = {False: 'kernel path', True: 'plain path'}
        if alt:
            m = cli.build_model(cli.build_parser().parse_args(
                argv + list(alt)), device)
            m.load_state_dict(net.state_dict())
            paths['alt'] = (make_train_step(parse_losses('l1')), TrainState(
                m, build_optimizer('ADAM', ['lr=1e-4'], m.parameters())))
            labels['alt'] = ' '.join(alt)
        times = {}
        for key, (step, state) in paths.items():
            times[key] = median_ms(lambda: step(state, lr, hr),
                                   launches=5, windows=3)
        for key, label in labels.items():
            print(f'{model} x{scale} train step ({label}): '
                  f'{times[key]:.3f} ms/step = '
                  f'{TRAIN_BATCH * 1e3 / times[key]:.2f} patches/s '
                  f'(batch {TRAIN_BATCH}, LR {patch // scale}x'
                  f'{patch // scale} -> HR {patch}x{patch}, '
                  f'L1 + Adam)  [{smi}]')
        for key in (False, 'alt') if alt else (False,):
            step, state = paths[key]
            _profile(lambda: step(state, lr, hr), times[key], smi, rules,
                     f'{model} x{scale} train step'
                     + ('' if key is False else f', {labels[key]}'))
    return counts


def _all_device_ms(run, calls: int = 3) -> float:
    """Device time of every kernel per call of ``run`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    return sum(_device_us(prof).values()) / 1e3 / calls


def _gan_parts(net, vgg, lr, hr, smi: str) -> None:
    """Device time of the SRGAN step's parts, each run alone at the
    step's shapes (torch.profiler, every kernel): the generator forward +
    backward and its K4r share, the discriminator's three forwards and
    two backwards, VGG19's two forwards and one backward, the two Adam
    updates."""
    g, d = net.generator, net.discriminator
    state = create_gan_state(net, 1e-4)

    def gen():
        g(lr).float().square().mean().backward()

    def disc():
        d.train()
        sr = g(lr).detach()
        (d(hr).float().mean() + d(sr).float().mean()).backward()
        d.eval()
        sr.requires_grad_()
        d.requires_grad_(False)
        d(sr).float().mean().backward()
        d.requires_grad_(True)
        d.train()

    def vg():
        sr = g(lr).detach().float().requires_grad_()
        vgg(sr, hr).backward()

    def adam():
        state.g_opt.step()
        state.d_opt.step()
    with torch.no_grad():
        sr_ms = _all_device_ms(lambda: g(lr))
    parts = {'generator forward + backward': _all_device_ms(gen),
             'of which K4r (its kernels)': _kernel_device_ms(
                 gen, K4_KERNELS + ('wgrad_kernel<', 'wgrad_reduce')),
             'discriminator (3 forward, 2 backward)':
                 _all_device_ms(disc) - sr_ms,
             'VGG19 to relu5_4 (2 forward, 1 backward; f32, TF32 '
             f'{"on" if torch.backends.cudnn.allow_tf32 else "off"})':
                 _all_device_ms(vg) - sr_ms,
             'Adam (G and D)': _all_device_ms(adam)}
    print('SRGAN x4 train step parts, each alone at the step\'s shapes '
          f'(device ms, torch.profiler)  [{smi}]: ' + ', '.join(
              f'{k} {v:.3f}' for k, v in parts.items()))


def run_gan_train(device, smi: str) -> dict:
    """Phase 18. ``fit --model SRGAN --use_pallas cs`` through the CLI at
    batch 16, patch 128, TRAIN_STEPS adversarial steps: the launch
    counters per step, g_loss and d_loss finite, the running statistics
    moved; from one set of params and batch, a kernel-path and a
    plain-path step held to an f32 step (every generator gradient and each
    block's BN2 dy, as phase 8); five steps' losses; the step's time on
    both paths (TF32 at PyTorch's default, on, for the VGG19's f32 convs
    as the CLI runs them; the kernel path also with it off); the device
    share and time by group. Returns the launch counts of the fit run."""
    scale, patch, steps = SCALE, TRAIN_PATCH, TRAIN_STEPS
    with tempfile.TemporaryDirectory(prefix='srtpu_smoke_gan_') as tmp:
        data = fit_data(Path(tmp), scale, patch)
        argv = ['fit', '--model', 'SRGAN', '--scale_factor', str(scale),
                *SRGAN_ARGS, '--datasets_dir', str(data),
                '--train_datasets', 'Train', '--batch_size',
                str(TRAIN_BATCH), '--patch_size', str(patch),
                '--optimizer_params', 'lr=1e-4', '--max_epochs', str(steps),
                '--precision', 'bf16', '--device', 'cuda', '--seed',
                str(SEED), '--default_root_dir', str(Path(tmp) / 'run')]
        log = _LossLog()
        logging.getLogger('srtpu_torch.train.loop').addHandler(log)
        for k in SRGAN_STEP_LAUNCHES:
            setattr(*_counter(k), 0)
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: getattr(*_counter(k)) for k in SRGAN_STEP_LAUNCHES}
        logging.getLogger('srtpu_torch.train.loop').removeHandler(log)
        need(rc == 0, f'fit returned {rc}')
        for k, per_step in SRGAN_STEP_LAUNCHES.items():
            need(counts[k] == per_step * steps,
                 f'{_counter_name(k)}: {counts[k]} launches in fit, '
                 f'expected {per_step} x {steps}')
        need(len(log.rows) == steps and np.isfinite(log.rows).all(),
             f'fit losses {log.rows}')
        print(f'SRGAN x{scale} fit CLI: {steps} steps in {wall:.3f} s (incl. '
              f'model init, VGG19 init, .npy reads, batching, logs); g_loss/'
              f'd_loss ' + ' '.join(f'{a:.4f}/{b:.4f}' for a, b in log.rows)
              + f'  [{smi}]')
        saved = torch.load(Path(tmp) / 'run' / 'final_weights.pt',
                           weights_only=True)
        stats = [k for k in saved if '.mean' in k or '.var' in k]
        for name in stats:
            t, init = saved[name].float(), float('.var' in name)
            need(bool(torch.isfinite(t).all()) and bool((t != init).any()),
                 f'{name}: running statistics not finite or never moved')
        print(f'SRGAN fit: {len(stats)} running statistics finite and moved')

        # kernel path, plain path and an f32 step from one set of params
        net = cli.build_model(cli.build_parser().parse_args(argv), device)
        net.train()
        batches = fit_batches(data, scale, patch, device)
        vgg = VGGLoss(device=device)

        def path(plain, dtype=torch.bfloat16):
            m = copy.deepcopy(net)
            m.generator.dtype = m.discriminator.dtype = dtype
            return (make_gan_train_step(vgg_loss=vgg, plain=plain),
                    create_gan_state(m, 1e-4))
        paths = {False: path(False), True: path(True)}
        lr, hr = batches[0]
        scales, rk, rp, rf = {}, [], [], []
        with _dy_record(bn_block.KERNELS, rk):
            paths[False][0](paths[False][1], lr, hr)
        with _dy_record(bn_block.PLAIN, rp):
            paths[True][0](paths[True][1], lr, hr)
        step32, st32 = path(True, None)
        with _db_scales(scales, 'trunk.'), _dy_record(bn_block.PLAIN, rf):
            step32(st32, lr, hr)
        gk, gp, gf = (_grads(s.generator) for s in (
            paths[False][1], paths[True][1], st32))
        for n, t in gk.items():
            need(t.dtype == torch.float32, f'{n} grad dtype')
        rows = _vs_f32(gk, gp, gf, scales)
        dy_rows = _dy_rows(rk, rp, rf)
        label = f'SRGAN x{scale} train step generator gradients'
        need(all(r <= 1.0 for r, _ in rows + dy_rows),
             f'{label}: ' + '; '.join(t for r, t in rows + dy_rows
                                      if not r <= 1.0))
        print(f'{label}, max_abs vs the f32 step, kernel/plain/tol (|f32|), '
              f'the four nearest their tolerance: '
              + ', '.join(t for _, t in rows[:4]) + '; the pre-BN biases: '
              + ', '.join(t for _, t in rows if '|grad|' in t)
              + '; per block, error/limit: '
              + ', '.join(f'{t} = {r:.4g}' for r, t in dy_rows))
        losses = {False: [], True: []}
        for j, (lr, hr) in enumerate(batches[1:]):
            for plain, (step, state) in paths.items():
                losses[plain].append(step(state, lr, hr))
        for key in ('g_loss', 'd_loss'):
            k, p = ([float(lg[key]) for lg in losses[x]] for x in (False,
                                                                   True))
            need(np.isfinite(k + p).all(), f'{key} not finite')
            print(f'SRGAN train {key} kernel / plain: ' + ' '.join(
                f'{a:.5f}/{b:.5f}' for a, b in zip(k, p)))
        g_rel = max(abs(float(a['g_loss']) - float(b['g_loss']))
                    / abs(float(b['g_loss']))
                    for a, b in zip(losses[False], losses[True]))
        print(f'SRGAN g_loss kernel vs plain: max rel {g_rel:.4g} (tol '
              f'{STEP_LOSS_TOL:.4g})')
        need(g_rel <= STEP_LOSS_TOL, 'kernel vs plain path g_loss')

        lr, hr = batches[0]
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
        try:
            times = {key: median_ms(lambda: step(state, lr, hr),
                                    launches=5, windows=3)
                     for key, (step, state) in paths.items()}
            step, state = paths[False]
            _profile(lambda: step(state, lr, hr), times[False], smi,
                     SRGAN_PROFILE, f'SRGAN x{scale} train step', top=8)
            _gan_parts(net, vgg, lr, hr, smi)
            torch.backends.cudnn.allow_tf32 = False
            times['tf32 off'] = median_ms(lambda: step(state, lr, hr),
                                          launches=5, windows=3)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        for key, label in ((False, 'kernel path'), (True, 'plain path'),
                           ('tf32 off', 'kernel path, cuDNN TF32 off')):
            print(f'SRGAN x{scale} train step ({label}): {times[key]:.3f} '
                  f'ms/step = {TRAIN_BATCH * 1e3 / times[key]:.2f} patches/s '
                  f'(batch {TRAIN_BATCH}, LR {patch // scale}x'
                  f'{patch // scale} -> HR {patch}x{patch}, D + G steps, '
                  f'VGG19 relu5_4, Adam)  [{smi}]')
    return counts


def main() -> None:
    t_start = time.perf_counter()
    device, smi = card()
    stats = check_kernels(device)
    stats.update(check_bwd_kernels(device))
    stats.update(check_rcab_kernels(device))
    stats.update(check_bn_kernels(device))
    stats.update(check_rdn_kernels(device))
    stats.update(check_k2_general(device, smi))
    stats.update(check_wdsr_kernels(device, smi))
    stats.update(check_bn_reflect_kernels(device, smi))
    # the main-path runs, each with the counters set to 0 before it
    runs = {'edsr_predict': run_slice(device, smi),
            'edsr_fit': run_train(device, smi)}
    runs['rcan_predict'] = run_slice(device, smi, 'RCAN', RCAN_ARGS,
                                     RCAN_PREDICT_LAUNCHES, RCAN_PROFILE)
    runs['rcan_fit'] = run_train(device, smi, 'RCAN', RCAN_ARGS,
                                 RCAN_STEP_LAUNCHES, RCAN_PROFILE)
    runs['srresnet_predict'] = run_slice(device, smi, 'SRResNet', (),
                                         SRRESNET_PREDICT_LAUNCHES)
    runs['srresnet_fit'] = run_train(device, smi, 'SRResNet', (),
                                     SRRESNET_STEP_LAUNCHES, SRRESNET_PROFILE,
                                     _grads_vs_f32)
    runs['rdn_predict'] = run_slice(device, smi, 'RDN', RDN_ARGS,
                                    RDN_PREDICT_LAUNCHES, RDN_PROFILE)
    runs['rdn_fit'] = run_train(device, smi, 'RDN', RDN_ARGS,
                                RDN_STEP_LAUNCHES, RDN_PROFILE)
    runs['ddbpn_predict'] = run_slice(device, smi, 'DDBPN', DDBPN_ARGS,
                                      DDBPN_PREDICT_LAUNCHES, DDBPN_PROFILE)
    runs['ddbpn_fit'] = run_train(device, smi, 'DDBPN', DDBPN_ARGS,
                                  DDBPN_STEP_LAUNCHES, DDBPN_PROFILE,
                                  _grads_ddbpn)
    for model, expected in (('EDSR', EDSR_X3_LAUNCHES),
                            ('SRResNet', SRRESNET_X3_LAUNCHES)):
        runs[f'{model.lower()}_x3_predict'] = run_slice(
            device, smi, model, (), expected, scale=3,
            sizes=SLICE_SIZES[:1])
    runs['wdsr_predict'] = run_slice(device, smi, 'WDSR', WDSR_ARGS,
                                     WDSR_PREDICT_LAUNCHES, WDSR_PROFILE,
                                     alt=WDSR_STOCK)
    runs['wdsr_fit'] = run_train(device, smi, 'WDSR', WDSR_ARGS,
                                 WDSR_STEP_LAUNCHES, WDSR_PROFILE,
                                 alt=WDSR_STOCK)
    runs['srresnet_x3_fit'] = run_train(
        device, smi, 'SRResNet', ['--n_resblocks', str(X3_FIT_BLOCKS)],
        SRRESNET_X3_STEP_LAUNCHES, SRRESNET_X3_PROFILE, _grads_vs_f32,
        scale=3, patch=X3_FIT_PATCH, steps=X3_FIT_STEPS)
    runs['srgan_predict'] = run_slice(device, smi, 'SRGAN', SRGAN_ARGS,
                                      SRGAN_PREDICT_LAUNCHES,
                                      SRGAN_PREDICT_PROFILE, profile_all=True)
    runs['srgan_fit'] = run_gan_train(device, smi)
    rep = 'srtpu/ops/cs_conv.py:'
    bn = 'srtpu/ops/bn_resblock_cs.py:'
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
            ('W', 'conv_wgrad (dW, db of the K1/K2/K3/K5 backward passes)',
             conv_wgrad, 'wgrad.cu', rep + '452'),
            ('K5', 'K5 rcab_fwd (RCAB conv pair, pool + MLP, gate)',
             rcab_fwd, 'rcab.cu', rep + '2593'),
            ('K5b', 'K5 rcab_bwd (pool sums, MLP bwd, dr2, dx chain; with its '
             'weight grads)', rcab_bwd, 'rcab.cu', rep + '2618'),
            ('K25', 'K2 conv3x3_fwd at 5x5 (SRResNet phase-dense 256->16)',
             CONV5_FWD, 'conv.cu', rep + '538'),
            ('K25b', 'K2 conv3x3_bwd at 5x5 (dx 16->256; with its 5x5 '
             'weight grads)', CONV5_BWD, 'conv.cu', rep + '581'),
            ('F1', 'K4 f1_conv_stats (conv + bias, stats of the stored y; '
             'reduce + finalize)', f1_conv_stats, 'bn_block.cu', bn + '315'),
            ('F2', 'K4 f2_norm_act_conv_stats (h1 = prelu(BN1) in the load, '
             'conv, stats)', f2_norm_act_conv_stats, 'bn_block.cu',
             bn + '324'),
            ('F3', 'K4 f3_norm_skip', f3_norm_skip, 'bn_block.cu',
             bn + '333'),
            ('B1', 'K4 b1_sums (S_g, S_gx)', b1_sums, 'bn_block.cu',
             bn + '346'),
            ('B2', 'K4 b2_call (BN2 bwd in the load, convT, PReLU bwd, BN1 '
             'sums)', b2_call, 'bn_block.cu', bn + '360'),
            ('B3', 'K4 b3_call (BN1 bwd in the load, convT, skip)', b3_call,
             'bn_block.cu', bn + '387'),
            ('K6', 'K6 rdn_fwd (16 dense blocks: 8 dense layers + the 1x1 '
             'fusion each; saving)', rdn_fwd, 'rdn.cu', rep + '2174'),
            ('K6b', 'K6 rdb_bwd_chain (one block: fusion bwd, dwf, dx chain, '
             'db)', rdb_bwd_chain, 'rdn.cu', rep + '2265'),
            ('K6w', 'K6 rdb_bwd_dw (one block: 36 pair weight grads)',
             rdb_bwd_dw, 'rdn.cu', rep + '2340'),
            ('K2g', 'K2 conv3x3_fwd, general path (c_in in chunks: DDBPN '
             'x4 32->512, 512->32, 512->48; EDSR x3 576->32)', K2G_FWD,
             'conv.cu', rep + '538'),
            ('K2gb', 'K2 conv3x3_bwd, general path (dx 512->32, 32->512, '
             '48->512; with its weight grads)', K2G_BWD, 'conv.cu',
             rep + '581'),
            ('Wg', 'conv_wgrad, general path (dW, db of DDBPN x4: (32, 512),'
             ' (512, 32), (512, 48))', WGG, 'wgrad.cu', rep + '452'),
            ('K2g5', 'K2 conv3x3_fwd at 5x5, general path (SRResNet x3 '
             '576->32)', K2G5_FWD, 'conv.cu', rep + '538'),
            ('K2g5b', 'K2 conv3x3_bwd at 5x5, general path (SRResNet x3 dx '
             '32->576; with its weight grads)', K2G5_BWD, 'conv.cu',
             rep + '581'),
            ('K7', 'K7 wdsr_fwd (WDSR-B block: fused 1x1 pair, h1 in shared '
             'memory; 3x3 + res_scale + skip)', wdsr_fwd, 'wdsr.cu',
             'srtpu/ops/wdsr_cs.py:135'),
            ('K7b', 'K7 wdsr_bwd (h2 recomputed, dh2, fused pointwise bwd '
             'with h1 recomputed, reductions; with dW3, db3)', wdsr_bwd,
             'wdsr.cu', 'srtpu/ops/wdsr_cs.py:159'),
            ('F1r', 'K4r f1_conv_stats, reflect (mirrored halo; stats of '
             'the stored y)', K4R_COUNTERS['F1'], 'bn_block.cu', bn + '315'),
            ('F2r', 'K4r f2_norm_act_conv_stats, reflect (h1 of the '
             'mirrored pixel in the halo)', K4R_COUNTERS['F2'],
             'bn_block.cu', bn + '324'),
            ('B2r', 'K4r b2_call, reflect (fold ring launch, convT + fold '
             'before the PReLU bwd and BN1 sums)', K4R_COUNTERS['B2'],
             'bn_block.cu', bn + '360'),
            ('B3r', 'K4r b3_call, reflect (fold ring launch, convT + fold '
             'before the skip and its rounding)', K4R_COUNTERS['B3'],
             'bn_block.cu', bn + '387')]
    rows = []
    for kid, name, fn, src, r in meta:
        st = stats[kid]
        by_path = {path: counts.get(fn, 0) for path, counts in runs.items()}
        need(sum(by_path.values()) > 0, f'{name}: no main-path launch')
        rows.append({
            'name': name, 'route': 'cuda',
            'source': 'srtpu_torch/ops/csrc/' + src, 'replaces': r,
            'launches': sum(by_path.values()), 'launches_by_path': by_path,
            'max_abs_err': st['max_abs_err'], 'ms': st['ms'],
            'plain_ms': st['plain_ms'], 'bound_ms': st['bound_ms'],
            'bound_by': ('operations' if st['ops_ms'] >= st['bytes_ms']
                         else 'bytes'),
            'library_ms': st['library_ms']})
    print(f'chip_smoke ran {time.perf_counter() - t_start:.1f} s '
          f'(kernel build included)')
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
