"""Drive srtpu_torch's EDSR-baseline x4, RCAN-10x16 x4, SRResNet x4,
RDN-B x4, DDBPN x4, WDSR-B x4, SRGAN x4 and SRCNN x4 predict and
training, EDSR's and RCAN's validate and EDSR's tiled eval and predict on
one CUDA card, EDSR's training on srtpu's other losses and its validate
with srtpu's six metrics, every route's ``export``, srtpu's Trainer
knobs, EDSR's, RCAN's and WDSR-B's ``use_pallas=True`` routes, the ops
of srtpu's other trunk forms, EDSR at 86 resblocks (where srtpu leaves
its mega trunk) and EDSR at 256 features (srtpu's XLA trunk).

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
1. the card: its name and power limit from nvidia-smi; the kernels are
   built from srtpu_torch/ops/csrc with nvcc (build/srtpu_torch/);
2. each forward kernel against its plain PyTorch version on the card,
   at the shapes the predict path gives it (LR 128x128 and a ragged
   67x45; batch 1, 64 channels, bf16), with the tolerance printed beside
   the error and median CUDA-event times of both; K3 also at the x8
   path's second stage (LR 256x256 and 134x90);
2b. each backward kernel (and K1's forward in its saving variant)
   against its plain version at the training shapes (batch 16, LR 32x32,
   64 channels, 16 resblocks; the tail's convs at 64x64) and at a ragged
   batch 2 of 67x45, with errors, tolerances and times, and two calls
   bit-identical (the weight grads use no float atomics); K2's backward
   rows (and those of 2f and 2j) also split into their two launches, dx
   and the weight grads, each timed beside its bound; K1 also at
   res_scale 0.1 beside 1.0 (forward saving and not, the backward); K3b
   also at the x8 path's second stage (batch 16 of 64x64, 2 x 134 x 90);
   K3's forward (LR 128x128 and the training shape) and backward (the
   training shape; its dx alone too) timed on the device alone (a CUDA
   graph of the calls) and on the host, beside cuDNN's calls for the
   same work (``F.conv2d`` 64 -> 256 then ``F.pixel_shuffle``;
   ``aten.convolution_backward`` of that conv);
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
   beside tolerances, the forward without saving bit-identical to the
   saving one's output, two calls bit-identical, kernel and plain times,
   device and host time a call and a group, device time by part (the
   conv pair, the passes, the dx chain, the weight grads);
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
   bf16 dy shown to fail its limit, two calls bit-identical, each
   function's device time alone (a CUDA graph of its calls), host time a
   call and the plain version's time. Phases 2 and 2b also hold K2 at
   5x5 (SRResNet's phase-dense 256 -> 16) forward and backward at the
   tail's shapes;
7. the SRResNet predict slice: phase 3's path and images with ``--model
   SRResNet`` (64 features, 16 resblocks, x4): eval mode, so per image
   K3 1, K2 3x3 1, K2 5x5 1 and no K4; PNGs at 4x; kernel path against
   plain path;
8. the SRResNet fit slice: phase 4 with ``--model SRResNet`` at full
   width and depth: per step K4's trunk op once each way (16 blocks + the
   close in one host call, its 33 weight grads inside) and no
   per-function K4 call, K2 and K3 forward and backward and their 3
   weight-grad launches; the loss falling, the running statistics finite
   and moved; the gradients of a kernel-path and a plain-path step
   against an f32 step (with phase 2n's per-block dy checks), the planted
   faults caught there too; five steps' losses,
   ms/step, patches/s, device time by kernel group.
2e. K6 (RDN's dense-block trunk) against its plain versions at the full
   B config (16 blocks of 8 layers, G = G0 = 64): the forward (cat and
   every saved buffer; the predict variant's shared buffer gives the
   same cat), one block's backward chain (dx, dout, dwf, dbf, db) and
   its 36 pair weight grads, at the training shape (batch 16, LR 32x32),
   the predict shape (batch 1, 128x128) and a ragged batch 2 of 67x45,
   every output beside its tolerance, two calls bit-identical, kernel
   and plain times; at the training and predict shapes each function's
   device time alone (a CUDA graph of its calls), CUDA-event and host
   time, beside cuDNN's calls for the same work (``rdn_reference``: the
   eight dense-layer convs and the 1x1 fusion, forward over 16 blocks,
   ``convolution_backward`` and ``conv2d_weight`` for one block), and
   the chain's device time by kernel;
9. the RDN predict slice: phase 3's path and images with ``--model RDN``
   (config B): per image one K6 forward and two K2 (SFE2, GFF2), no other
   kernel; PNGs at 4x; kernel path against plain path; device time by
   kernel group of the 512x352 forward;
10. the RDN fit slice: phase 4 with ``--model RDN`` at full width and
   depth: per step one K6 forward, 16 chains and 16 pair weight-grad
   calls, K2 2 + 2 and its 2 weight grads; the loss falling, kernel-path
   against plain-path gradients and losses, ms/step, patches/s, device
   time by kernel group.
2f. K2 (its wgmma engine, conv_sm90.cuh; any multiples of 16) against
   its plain version at every general shape DDBPN and the x3 tails give
   it: forward 32 -> 512, 512 -> 32, 512 -> 48 (x4), 32 -> 128, 128 -> 32,
   128 -> 16 (x2), 576 -> 32 at 3x3 and 5x5 and 64 -> 576 (x3), and the
   backward of each (dx the reverse shape, dW and db through the
   weight-grad kernel), at the training shape (batch 16, LR 32x32), the
   predict shape (batch 1, 128x128) and a ragged batch 2 of 67x45; errors
   beside K2's tolerances, two calls bit-identical, kernel, plain and
   library times;
2k. K2's forward at the training shape (batch 16, LR 32x32) at each
   shape of the EDSR x4 tail, SRResNet's 5x5, DDBPN x4 and the x3 tails,
   against its plain version, two calls bit-identical, with kernel,
   plain, bound and library times;
2l. the weight-grad engine (W) at every class the main paths launch
   (``W_CASES``: stacked jobs, a scaled cotangent, the r = 2 gather,
   REFLECT, 3x3 and 5x5 256 -> 16, DDBPN x4's three, 576 -> 32 at 3x3
   and 5x5, K9c's 64 i -> 64, K7's 128 -> 128, K9d's 64 -> 128) at the
   training shape and at 2 x 67 x 45, against its plain version within
   1e-4 of the largest magnitude, two calls bit-identical, with its
   time, bound and ``conv2d_weight``'s (cuDNN's heuristics and benchmark
   mode) at the training shape (the W row's ``classes``);
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
   versions at C = 128 (e 768, Lp 112; the kernels pad to 128): the
   training shape (batch 16, LR 32x32), the predict shape (batch 1,
   128x128) and a ragged batch 2 of 67x45, one block and the 16-block
   trunk in one host call each way; out, the saved block inputs, dx and
   the six f32 grads beside their tolerances, two calls bit-identical,
   kernel, plain and bound times (the bound counts the block's work at
   its bottleneck L = 102, not the kernels' padded Lp), the trunk's
   device and host times, and one bf16 block on cuDNN (channels-last
   weights, benchmark mode) timed each way beside, on the device too;
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
   (each margin printed); each K4r function's device time (a CUDA graph)
   beside K4's on the same inputs, and its host time; one reflect block
   on cuDNN in bf16 (channels-last weights, benchmark mode) timed beside
   a K4r block, forward and forward + backward;
2n. K4's and K4r's trunk op (one host call each way: 16 blocks + the
   close, the 33 weight grads in one launch of W) through the model's
   trunk at the training shape, SAME and REFLECT: the kernel and plain
   paths (both bf16) against an f32 path (every grad, dx, out, within
   BN_TRUNK_VS_F32 times the plain path's error; each block's BN2
   backward dy per element and its invariants, per channel mean(dy) and
   mean(dy * xhat), 0 in f32, within BN_INVARIANT_VS_F32), the running
   statistics kernel vs plain, two faults planted in B2 caught by that
   check (margins printed), two calls bit-identical, and the trunk op
   against its blocks run one by one through the per-function kernels
   (bit for bit but for the weight grads, whose W split differs: 1e-4);
   its device time each way (a CUDA graph), host time and the plain
   trunk's time;
17. the SRGAN predict slice: phase 3's path and images with ``--model
   SRGAN`` at srtpu's sizes (ngf = ndf = 64, 16 blocks, x4): eval mode,
   so no kernel of the port runs (the trunk on its running statistics
   through reflect-padded stock convs, as srtpu's eval on XLA); PNGs at
   4x; the forward times;
18. the SRGAN fit slice: ``fit --model SRGAN --use_pallas cs`` at batch
   16, patch 128, 20 adversarial steps (D then G, VGG19 relu5_4 content
   term): per step K4r's trunk op once each way (its 33 reflect weight
   grads inside) and no other K4 call; g_loss and d_loss finite, the running
   statistics moved; a kernel-path and a plain-path step held to an f32
   step (every generator gradient, each block's BN2 dy; cuDNN's
   deterministic algorithms, so the held ratios repeat bit for bit:
   ``gan_held_repeat`` runs it four times); the step's time
   on the kernel and plain paths (and the kernel path with TF32 off),
   patches/s, the device share and device time by group (K4r, Adam, the
   rest; D, VGG19 and the generator timed alone).
2i. K8 (srtpu's use_pallas=True forms): K8a (EDSR's fused block, out and
   h1), K8b (RCAN's channel-attention gate) and K8c (WDSR-B's fused
   block at C = 128) against their plain versions at the training shape
   (batch 16, LR 32x32), the predict shape (batch 1, 128x128) and a
   ragged batch 2 of 67x45 (K8b also at 1 x 512 x 352, past its
   K_PIX blocks): every output within one bf16 step of its largest magnitude,
   two calls bit-identical, kernel, plain and bound times (no single
   PyTorch call computes any of them: library null); K8b's pixels a
   block, device time (a CUDA graph) and host time at each shape; K8c over 16 blocks
   (one call a block, as the True route runs it), device and host time;
   K8a's block device and host time beside cuDNN's calls for its work
   (two ``F.conv2d``, ReLU and the scaled skip: h1 rounded, so a
   reference, not the same function), and its trunk op over 16 blocks
   (one host call) at the training shape, 1 x 128 x 128 and 2 x 67 x 45,
   forward saving and not against the per-block plain route (within
   four bf16 steps of the largest magnitude, as K1's trunk), two calls
   bit-identical, the trunk's output equal to 16 per-block kernel calls,
   and through autograd each way bit for bit the per-block kernel
   route's output and gradients (the plain route's gradients printed
   beside), with its device and host time and cuDNN's 16 blocks beside;
19. the EDSR True route: phase 3's path on its LR 128x128 image with
   ``--model EDSR --use_pallas true`` (64 features, 16 blocks; no
   device profile): per image 16 K8a blocks in one trunk call and no
   K1, K2 or K3; PNGs at 4x; kernel path against plain path; then ``fit
   --use_pallas true``
   (phase 4's recipe, 10 steps; the step timed in 3 windows of 2): 16
   K8a blocks per step in one trunk call (the backward
   stock) and none of K1-K3 or the
   weight-grad kernel, the loss falling, kernel-path against plain-path
   gradients and five losses, ms/step, patches/s; the 'cs' route of the
   same weights beside the forward per image (its time, the largest
   difference);
20. the RCAN True route, as 19 with ``--model RCAN`` (10 groups of 16
   RCABs): per image and step 160 K8b launches and no K5 or K2;
21. the WDSR-B True route, as 19 with ``--model WDSR`` (128 features, 16
   blocks): per image and step 16 K8c launches and no K7.
2j. the counterparts of srtpu's other trunk forms and K8a's fused
   backward against their plain versions at the training shape (batch
   16, LR 32x32), two calls bit-identical, with kernel, plain, bound and
   library times: K1 over 86 blocks (srtpu's per-block ``trunk_cs``
   there) and at one block (``resblock_cs``), K6 at one RDN-B block
   (the 'calls' trunk: forward, chain, pair weight grads), K9c (the 8
   dense-layer convs of one block, forward and backward; ``F.conv2d``
   and ``aten.convolution_backward`` beside), K9d at res_scale 1.0 and
   0.1 (each call's plan among ``k9d_held``'s; its device and host time
   beside the True route's stock f32 backward and the bf16 cuDNN calls
   of its two conv VJPs); then the main-path runs
   of the ops no model keyword reaches: ``resblock_cs`` and
   ``resblock_fused_v3`` at EDSR True's training shape,
   ``rdn_trunk_calls`` (its forward bit-identical to the grid trunk's)
   and ``rdn_trunk_layers`` at RDN-B's trunk shape, each forward and
   backward with its launches counted and its gradients against its
   plain path; one BN block and the close through the per-function K4
   wrappers (``bn_resblock``, ``bn_close``), SAME and REFLECT, likewise
   (the pre-BN biases' grads, rounding noise, held in 2n);
2m. K1 at L = 16 (the training shape and LR 128x128 at res_scale 1.0),
   86 and 1 (the training shape at 0.1): the forward saving and not and
   the backward against their plain versions within phases 2b's and
   2j's limits, two calls bit-identical; the device time of a call
   alone (a CUDA graph of the calls) and its host time, forward saving
   and not, the dx chain alone and with its weight grads, beside
   cuDNN's calls for the same work (``trunk_reference``);
22. EDSR x4 at 64 features and 86 resblocks (res_scale 0.1), the
   shallowest 64-feature trunk srtpu sends to ``trunk_cs``: a 10-step
   ``fit`` through the CLI on K1 (86 launches each way per step), the
   gradients against the plain path;
23. EDSR x4 at 256 features, 32 resblocks, res_scale 0.1 (the EDSR
   paper's): predict at LR 128x128 and a 10-step ``fit`` through the
   CLI on srtpu's XLA trunk and tail (stock ops): no kernel of the port
   runs, which the counters show; ms and patches/s;
24. SRCNN x4: phase 3's predict (no kernel counter moves: its bicubic is
   two f32 matmuls, its convs cuDNN's) and phase 4's 20-step fit;
25. ``python -m srtpu_torch validate``'s own function, EDSR-baseline x4
   on an eval set of HR 512x512, 1000x680 (bucket-padded) and 2048x1408
   with PSNR, SSIM and MS-SSIM: K1, K2 and K3 on every image (the
   counters); per image the kernel path's metrics against the plain
   path's, the card's metric functions against the CPU's on the same SR
   and HR (PSNR 1e-4 dB, SSIM and MS-SSIM 1e-5), the masked values
   against the unpadded image's; eval ms per image, forward and metrics
   apart, and images/s; then RCAN-10x16 on the same set (K5 and K2 on
   every image, its metrics against its plain path);
26. the tiled steps: K1-K3 at the 16 x 80 x 80 tile batch against their
   plain versions; EDSR ``validate`` and ``predict`` with ``--eval_tile
   80 --eval_tile_overlap 8`` on the 2048x1408 image (K1-K3 on every
   16-tile batch) and ``predict --predict_tile 128`` (the host tiles),
   each PNG byte-equal to the route's SR checked here; the tiled kernel
   path against the tiled plain path and against the direct forward
   (beside srtpu's seam figure, ROADMAP F2); tiled ms against direct;
27. ``fit`` with validation and checkpoints through the CLI, EDSR-baseline
   x4 at full width (the phase 4 recipe): (a) 4 epochs of 5 steps with
   ``--eval_datasets Val`` (HR 512x512 and the bucket-padded, masked
   1000x680), ``--check_val_every_n_epoch 2``, ``--save_top_k 1``: the
   launch counters equal phase 4's per step x 20 plus the per-image eval
   launches of the sanity pass and the two val passes; ``checkpoints/
   top`` holds the one epoch with the best ``Val/PSNR`` of
   ``metrics.jsonl``; ``last`` and ``hparams.json`` exist; every logged
   value is finite; (b) the same fit with a step that raises at the start
   of epoch 3 (a hook here), then ``--ckpt_path last`` to epoch 4: the
   resumed run's losses of epochs 3-4, its last val pass and its final
   weights equal (a)'s bit for bit (K1-K3 and W sum in a fixed order;
   (a) and (b) under ``_cudnn_deterministic``); (c) ``validate
   --checkpoint`` on (a)'s directory matches (a)'s val pass of the kept
   epoch within 1e-6 and ``predict --checkpoint`` writes the PNGs of
   ``predict --weights`` on that state, byte for byte; each of the two
   launches K1-K3 per image (the model rebuilt from ``hparams.json`` on
   the kernel route). It prints the
   fit's wall time with and without its val passes, a checkpoint save's
   and a restore's ms and the val pass's ms an image. (a) also logs the
   weight histograms every 2 epochs;
28. on phase 27's run (``run_phase28``): the host time ``srtpu::``
   operators add to ``conv3x3_fwd`` and ``trunk_fwd`` against their
   ctypes launches called directly; (1) ``export`` of (a)'s checkpoint,
   EDSR-baseline x4 at full width and depth, ``--size 128x128``,
   ``512x352`` and ``512x352 --tile 80`` (no kernel launched while
   tracing), the three programs loaded and run in one fresh ``python3 -c``
   process that imports ``srtpu_torch.export`` alone: each output equal
   to the eager predict step's (the tiled predict step's) bit for bit,
   K1 one call of 16 blocks, K2 3 and K3 1 per image (per tile batch) by
   the counters, the exported and the eager ms per image (CUDA events,
   median of 5); (2) RCAN 'cs', RDN-B, DDBPN, WDSR-B 'cs', SRResNet,
   SRCNN and the EDSR, RCAN and WDSR-B True routes at 2 blocks or groups,
   exported, saved, loaded: equal to eager predict bit for bit with its
   launches; (3) 3 train steps with and without ``remat``, EDSR-baseline
   and RCAN-10x16: parameters bit for bit, peak memory, step ms; (4) two
   ``--deterministic`` fits of 5 steps each of EDSR-baseline and SRGAN
   'cs': final weights bit for bit, torch's and cuDNN's flags back after
   each; the deterministic step's ms; (5) a fit with a NaN weight under
   ``detect_anomaly`` raises ``FloatingPointError``; the step ms of the
   fit without the knob beside phase 4's; (6) a fit with
   ``--profiler_dir``: one trace naming the ``srtpu::`` operators and
   the engines' kernels; (7) (a)'s TensorBoard event file read back
   (CRCs; scalars, images, histograms) and its three run assets, with
   their wall time;
29. srtpu's other losses and metrics (``run_phase29``, under PyTorch's
   TF32 default for cuDNN): (a) for each of ``0.5 * l1 + 0.5 *
   adaptive``, ``flip``, ``haarpsi``, ``pieapp``, ``lpips``, ``dists``,
   ``0.5 * l1 + 0.5 * edge_loss``, ``0.5 * l1 + 0.5 * pencil_sketch``
   and ``edge_loss`` alone, 8 steps of ``fit --losses`` through the
   CLI's function on EDSR-baseline x4 at the bench recipe: phase 4's
   launches per step (``edge_loss`` alone: the forward's, no backward),
   the losses finite and falling (``edge_loss`` alone carries no
   gradient); on one held batch the loss and its SR gradient
   on the card against the CPU on the card's SR and HR (the losses'
   convolutions in full f32; PieAPP's max-pool decisions counted
   against the CPU's, and its gradient also with the CPU's pool
   decisions forced on the card); the
   step's ms (CUDA events, median of 3 windows of 5) beside l1's, its
   peak memory and its device time by kernel; (b) ``validate --metrics
   BRISQUE FLIP LPIPS MS-SSIM PSNR SSIM`` on phase 25's HR 512x512 and
   1000x680: K1-K3 per image, each metric card against CPU per image,
   BRISQUE on the true shape (the printed mean is the true-shape
   scores'), each new metric's ms per image beside the forward's; (c) a
   fit with ``0.5 * l1 + 0.5 * edge_loss`` and val writes each image's
   SR, centre crop and their ``_edges`` maps, the HR's once;
30. ``steps_per_execution`` (``run_phase30``): a window of k train steps
   is one replay of a CUDA graph (``train.graph.StepGraph``). (a)
   EDSR-baseline x4 at the bench recipe through the CLI's function: 20
   steps of ``fit --steps_per_execution 4`` (2 epochs of 10 batches: 2
   windows and 2 single steps each) against 20 steps at k 1 on the same
   batches: the weights and each window's last loss bit for bit, phase
   4's launches per step x 20, one capture and one replay a later
   window (these fits with cuDNN's deterministic algorithms);
   ``--accumulate_grad_batches 3`` (30 steps, the phases cycling: one
   capture per starting phase) held the same way; one epoch with
   ``--remat true --deterministic true --profiler_dir`` at k 4 against
   k 1 (the trace holds the graph's launches); a fit stopped after its
   first epoch and resumed with ``--ckpt_path last`` equal to the
   uninterrupted fit bit for bit; (b) RCAN 'cs', SRResNet,
   RDN-B, DDBPN, WDSR-B 'cs', the EDSR, RCAN and WDSR-B True routes and
   SRCNN at full width (depth 2; RDN config B's 16 blocks): 2 windows of
   2 steps, graph against eager bit for bit (cuDNN's deterministic
   algorithms for the stock head and tail convs), their launch counters
   equal; (c) RMSprop, Ranger, RangerVA and RangerQH on EDSR-baseline
   x4: graph against eager bit for bit, and the first update on the
   card against the CPU's on the same gradients; (d) for EDSR-baseline,
   SRResNet, DDBPN and WDSR-B 'cs' at full depth, the bare step's ms at
   k 1 and 4 (CUDA events, batches on the card), its device time, the
   device's share, the SM and memory clocks over 1.5 s of such steps
   (``nvidia-smi`` every 20 ms), and the 20-step fit's wall at both; a
   step that reads its loss on the host makes the capture raise;
31. the training loader's throughput path (``run_phase31``): 800 HR
   images of 256x256 and their LR at 64x64 (``LR/X4``), uint8 ``.npy``
   drawn from SEED (DIV2K's count of training images: 50 steps an
   epoch at batch 16; about 168 MB). (a) the loader alone, batches
   prefetched to the card: patches/s over an epoch (its RAM cache
   filled) for the numpy and the native core at ``num_workers`` 1 and
   auto, ``prefetch`` 2; (b) its batches on the card, copied back,
   against the host loader's for two epochs, bit for bit; (c)
   EDSR-baseline x4 ``fit`` at the bench recipe for 3 epochs through the
   CLI's function at k 1 and at k 4 (epoch 1 fills the RAM cache and
   captures; epochs 2 and 3 are the steady state, cuDNN's deterministic
   algorithms): ms a step and patches/s, the consumer's wait in
   ``next()`` a step, the copy to the card a batch (CUDA events on the
   producer's stream), phase 30's bare step beside them; held: the k 4
   weights equal to the k 1 weights bit for bit, a capture made while the
   producer thread is live, the native core in ``run.log``, phase 4's
   launches per step x 150.
32. srtpu's XLA routes (``run_phase32``), at full width: SRResNet x4
   ``--use_pallas false`` (64 features, 16 blocks), RDN x4 ``--rdn_config
   A`` (D 20, C 6, G 32, G0 64: srtpu's per-block path on 'cs'), RDN-B x4
   ``--use_pallas false`` (predict only), DDBPN x4 ``--use_pallas
   false`` (n0 128, nr 32, depth 6: the fine ``ConvTranspose2d`` and
   strided convs) and DDBPN x8 'cs' (srtpu's XLA coarse branch, stock
   convs at c_in 2048): phase 3's predict at LR 128x128 (RDN-B's at
   ``--precision 32``; no device profile) and a 10-step ``fit`` at phase
   4's recipe through the CLI's functions (with the step's device
   profile), every kernel counter of the port at 0 on each; then each
   model's eval forward on the card against the
   same forward on the CPU (the card's parameters, one LR 32x32 image)
   within one bf16 step (2^-7) of the largest magnitude.
The line before the last is a JSON object with, per kernel, its launches
in the main-path runs (EDSR, RCAN, SRResNet, RDN, DDBPN, WDSR, SRGAN
and SRCNN predict and fit, EDSR and SRResNet x3 predict, SRResNet x3
fit, the EDSR, RCAN and WDSR-B True routes' predict and fit, EDSR 64 x
86 fit, EDSR's and RCAN's validate, EDSR's tiled validate and predict
and its host tiles, phase 27's fit with validation and its ``validate``
/ ``predict --checkpoint``, phase 28's exported programs and its
profiled fit, phase 29's fits and validate, phase 30's fits and
routes, phase 31's fits, and phase 2j's op runs; phase 32's runs count
none;
``launches`` is their sum), its largest error against its plain
version, its time (K4's, K4r's and the trunk op's: its device time
alone, a CUDA graph of its calls; the others: the wrapper's CUDA-event
time) and the
plain version's at the main path's shapes, the least time the card could take for the same
work (``bound_ms``: the larger of the bytes the function must move over
3.35 TB/s and its matrix FLOPs over 989 TFLOP/s bf16, NVIDIA's H100 SXM
figures) and the time of one
PyTorch call computing the same function where there is one
(``library_ms``, a yardstick the port never calls, timed with cuDNN's
heuristics as set here; ``library_bench_ms`` the same call with
``torch.backends.cudnn.benchmark`` on). K2's backward rows add ``dx_ms``
/ ``dx_bound_ms`` and ``wgrad_ms`` / ``wgrad_bound_ms``, their two
launches, and ``wgrad_library_ms`` / ``wgrad_library_bench_ms``, the
weight grads' own ``conv2d_weight``; the W row adds ``classes``, phase
2l's. The last line is
``{"ok": true, "device": {...}}``. Without CUDA (or without the repo)
it exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import importlib
import io
import json
import logging
import struct
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from srtpu_torch import cli
from srtpu_torch.checkpoint import CheckpointManager
from srtpu_torch.data import SRData, pad_to_bucket
from srtpu_torch.losses import VGGLoss, parse_losses
from srtpu_torch.metrics import (brisque_exact, brisque_features,
                                  build_metrics)
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
                             resblock_cs, trunk_bwd, trunk_bwd_plain,
                             trunk_fwd, trunk_plain, upsample_bwd,
                             upsample_bwd_plain, upsample_fwd,
                             upsample_plain)
from srtpu_torch.ops import ca_layer as k8b_ops
from srtpu_torch.ops.ca_layer import ca_layer_fwd, ca_layer_plain
from srtpu_torch.ops.conv import conv3x3_dx
from srtpu_torch.ops.layout import pm_from_fine, w_pm_hwio, w_t
from srtpu_torch.ops.rdn import (pack, rdb_bwd_chain, rdb_bwd_chain_plain,
                                 rdb_bwd_dw, rdb_bwd_dw_plain, rdn_fwd,
                                 rdn_fwd_plain, rdn_trunk, rdn_trunk_calls,
                                 rdn_trunk_layers, unpack)
from srtpu_torch.ops.resblock import (resblock_bwd_fused,
                                      resblock_bwd_fused_plain,
                                      resblock_fused_bwd, resblock_fused_fwd,
                                      resblock_fused, resblock_fused_plain,
                                      resblock_fused_v3)
from srtpu_torch.ops import wdsr as k7ops
from srtpu_torch.ops.wdsr import (wdsr_bwd, wdsr_bwd_plain, wdsr_fwd,
                                  wdsr_fwd_plain, wdsr_lp)
from srtpu_torch.ops.wdsr_block import (wdsr_block_fused_fwd,
                                        wdsr_block_fused_plain)
from srtpu_torch.optim import build_optimizer
from srtpu_torch.train import (Trainer, TrainerConfig, TrainState, Updater,
                               create_gan_state, loss_parameters,
                               make_eval_step, make_gan_train_step,
                               make_predict_step, make_tiled_predict_step,
                               make_train_step, tiled_predict)
from srtpu_torch.train import loop as train_loop
from srtpu_torch.train.tiled import _anchors
from srtpu_torch.utils.imgops import cudnn_tf32
from srtpu_torch.utils.logging import save_image

# K4's trunk op, looked up with getattr: tools/tree_timing.py loads this
# file over other trees' srtpu_torch, and a tree from before it has none
bn_trunk_fwd = getattr(bn_block, 'bn_trunk_fwd', None)
bn_trunk_bwd = getattr(bn_block, 'bn_trunk_bwd', None)
# K8a's trunk op and K3's dx alone, the same way
k8a_ops = importlib.import_module('srtpu_torch.ops.resblock')
k3_ops = importlib.import_module('srtpu_torch.ops.upsample')
resblock_trunk_fwd = getattr(k8a_ops, 'resblock_trunk_fwd', None)
resblock_trunk_plain = getattr(k8a_ops, 'resblock_trunk_plain', None)
resblock_fused_trunk = getattr(k8a_ops, 'resblock_fused_trunk', None)
upsample_dx = getattr(k3_ops, 'upsample_dx', None)

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
# phase 2b's batches of LR patches: the training shape and a ragged one
BWD_SIZES = ((TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE),
             (2, 67, 45))
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
# Phase 2c's K5 shapes (the training shape, the predict shape and a ragged
# batch) and the group lengths K5 is held at on the card: 1 (one RCAB,
# each shape) and RCABS (a group, the training shape), each way and, in
# the forward, saving and not (tests/test_torch_k5_plans.py holds that
# these cover the plans RCAN launches)
K5_SHAPES = ((TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE),
             (1, 128, 128), (2, 67, 45))
K5_GROUPS = (1, RCABS)
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
                             trunk_fwd: 0, rcab_fwd: 0, bn_trunk_fwd: 0,
                             **{fn: 0 for fn in K4_FNS.values()}}
# K4's trunk op (one host call a trunk each way: the 16 blocks, the close
# and, in the backward, their 33 weight grads in one launch of W), with
# SAME boundaries (counted on launches) and REFLECT (launches_reflect)
K4T = {False: (bn_trunk_fwd, bn_trunk_bwd),
       True: ((bn_trunk_fwd, 'launches_reflect'),
              (bn_trunk_bwd, 'launches_reflect'))}
# per SRResNet train step: the trunk op once each way (none of the
# per-function wrappers); the tail's K2 and K3 each way and their weight
# grads (K2 3x3 and 5x5, K3)
SRRESNET_STEP_LAUNCHES = {
    K4T[False][0]: 1, K4T[False][1]: 1, K4T[True][0]: 0, K4T[True][1]: 0,
    **{fn: 0 for fn in K4_FNS.values()}, conv3x3_fwd: 1,
    conv3x3_bwd: 1, CONV5_FWD: 1, CONV5_BWD: 1, upsample_fwd: 1,
    upsample_bwd: 1, conv_wgrad: 3, trunk_fwd: 0, trunk_bwd: 0,
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
# the K4 kernels' names (torch.profiler), for their own device time: its
# convs on K2's engine at K4's epilogues (EPI 9: F1, F2; 10: B2; 11: B3)
# and its passes
K4_KERNELS = ('conv_sm90_kernel<64, 1, 4, 1, false, 9>',
              'conv_sm90_kernel<64, 1, 4, 1, true, 10>',
              'conv_sm90_kernel<64, 1, 4, 1, true, 11>', 'bn_act_kernel',
              'bn_norm_skip_kernel', 'bn_sums_kernel', 'bn_dy_kernel',
              'bn_reduce_kernel', 'bn_fold_ring_kernel')
# K4r (SRGAN's generator block): F1, F2, B2 and B3 with reflect=True,
# counted apart from K4's SAME launches; F3 and B1 pad nothing and are
# K4's own. Phase 2h's shapes: the training shape and a ragged one (not a
# multiple of the 8 x 16 tile).
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
# (K6's own launches of K2's and W's engines count on K6's wrappers)
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
# Phase 2e's K6 shapes (the training shape, the predict shape and a
# ragged batch) and the block counts K6 is held at on the card: RDN_D (the
# grid trunk, 2e) and 1 (the calls trunk's per-block forward, 2j), each
# at RDN_C dense layers (tests/test_torch_k6_plans.py holds that these
# cover the plans RDN-B launches)
K6_SHAPES = ((TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE),
             (1, 128, 128), (2, 67, 45))
K6_BLOCKS = (RDN_D, 1)
# Each block's BN2 backward dy against the f32 path (phase 2d's trunk and
# phase 8's step): per element within BN_TRUNK_VS_F32 times the plain
# path's largest error in its channel plus one bf16 step of the element;
# its invariants, mean(dy) and mean(dy * xhat) per channel (0 in f32: the
# BN backward subtracts both projections), within BN_INVARIANT_VS_F32
# times the plain path's largest error of that block's row. A term missing
# from dy breaks the invariants coherently over all of a channel's pixels.
BN_INVARIANT_VS_F32 = 4.0
# K2's general shapes (DDBPN's, the x3 tails', RDN's dense layers past 64
# channels; one engine runs every shape, the counters keep the classes
# apart) and the weight grads of those shapes (one engine too, counted
# on conv_wgrad.launches_general)
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
                          K4T[True][0]: 0, K4T[False][0]: 0,
                          conv3x3_fwd: 0, upsample_fwd: 0, conv_wgrad: 0}
# per SRGAN train step: K4r's trunk op once each way (its 33 reflect
# weight grads inside); no per-function K4 / K4r call, no SAME K4, K2 or
# K3, no other weight grad
SRGAN_STEP_LAUNCHES = {
    K4T[True][0]: 1, K4T[True][1]: 1, K4T[False][0]: 0, K4T[False][1]: 0,
    **{k: 0 for k in K4R_COUNTERS.values()},
    **{fn: 0 for fn in K4_FNS.values()}, conv_wgrad: 0, WGG: 0,
    conv3x3_fwd: 0, conv3x3_bwd: 0, upsample_fwd: 0, upsample_bwd: 0}
# (c_in, c_out, k) of phase 2f: DDBPN x4 (nr 32) up, down and output
# convs, x2 up, down and output convs, EDSR's and SRResNet's x3
# phase-dense convs, and the x3 tails' phase-major 64 -> 576 (counted on
# ``launches``: c_in 64); each backward's dx is the reverse shape
K2G_SHAPES = ((32, 512, 3), (512, 32, 3), (512, 48, 3), (32, 128, 3),
              (128, 32, 3), (128, 16, 3), (576, 32, 3), (576, 32, 5),
              (64, 576, 3))
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
                             upsample_fwd: 0, upsample_bwd: 0,
                             K4T[False][0]: 1, K4T[False][1]: 1}
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
# K7's trunk of WDSR_L blocks in one call each way against the plain
# versions block after block: each block's input carries the earlier
# blocks' one-step differences, so out, the saved block inputs and dx
# within four steps, as K1's 16-block trunk (TOL_STEPS['K1']); the
# weight and bias grads, each a sum over the pixels of products with a
# block's cotangent, which carries the later blocks' dx differences,
# within two steps (one block's are held to one, K7B_STEPS).
K7T_STEPS = {'out': 4, 'xs': 4}
K7TB_STEPS = {'dx': 4, 'dw1': 2, 'db1': 2, 'dw2': 2, 'db2': 2, 'dw3': 2,
              'db3': 2}
# phase 2g holds the trunk at srtpu's res_scale and, at the ragged shape,
# at 0.1 (the backward's gs pass)
K7_SCALES = (1.0, 0.1)
# srtpu's use_pallas=True routes (K8), at the same full widths and depths
# as their 'cs' runs: EDSR-baseline (K8a per block), RCAN-10x16 (K8b per
# RCAB), WDSR-B at 128 features (K8c per block); the 'cs' route of the
# same weights is timed beside each
TRUE_ARGS, CS_ROUTE = ['--use_pallas', 'true'], ('--use_pallas', 'cs')
# the True routes' runs, cut to hold the script's time: predict at LR
# 128x128 alone, 10 fit steps (the falling-loss check's two halves of 5),
# each route's step timed in 3 windows of 2 steps, no device profile and
# no 'cs' step beside
TRUE_FIT_STEPS, TRUE_TIMING = 10, (2, 3)
K8_OFF = {trunk_fwd: 0, upsample_fwd: 0, conv3x3_fwd: 0, rcab_fwd: 0,
          wdsr_fwd: 0}
K8_OFF_BWD = {trunk_bwd: 0, upsample_bwd: 0, conv3x3_bwd: 0, rcab_bwd: 0,
              wdsr_bwd: 0, conv_wgrad: 0}
# per image and per train step: the K8 kernel once per block (per RCAB;
# K8a's L blocks in one trunk call, counted on the trunk op's launches
# and calls, and no per-block call); the backward is stock PyTorch
# (srtpu's is XLA), and so are the close convs and the tail: no K1-K3,
# K5 or K7 launch
K8A_TRUNK = ({resblock_trunk_fwd: L, (resblock_trunk_fwd, 'calls'): 1}
             if resblock_trunk_fwd else {})
EDSR_TRUE_LAUNCHES = {**K8A_TRUNK, resblock_fused_fwd: 0, **K8_OFF}
EDSR_TRUE_STEP_LAUNCHES = {**EDSR_TRUE_LAUNCHES, **K8_OFF_BWD}
RCAN_TRUE_LAUNCHES = {ca_layer_fwd: GROUPS * RCABS, **K8_OFF}
RCAN_TRUE_STEP_LAUNCHES = {**RCAN_TRUE_LAUNCHES, **K8_OFF_BWD}
WDSR_TRUE_LAUNCHES = {wdsr_block_fused_fwd: WDSR_L, **K8_OFF}
WDSR_TRUE_STEP_LAUNCHES = {**WDSR_TRUE_LAUNCHES, **K8_OFF_BWD}
# K8 against its plain version on the same inputs: both compute the same
# f32 function and round once (K8a's h1 once more), the kernels' hi + lo
# pairs within 2^-17 of f32: every output within one bf16 step of its
# largest magnitude
K8_STEPS = 1
# K8b beyond phase 2i's three shapes: RCAN's predict at the slices' largest
# LR (an image past MAX_SPLITS blocks of K_PIX pixels)
K8B_SHAPES = ((1, 512, 352),)
# EDSR x4 at 64 features and 86 resblocks: the shallowest 64-feature trunk
# srtpu sends to its per-block trunk_cs: 2 * 86 * 192^2 * 4 bytes of
# mega-trunk dW accumulators pass its 24 MiB TPU budget (85 blocks do
# not). The port runs K1 at every depth (it keeps no such accumulators).
# res_scale 0.1, the EDSR paper's setting for deep trunks (Lim et al.
# 2017), keeps the random-init activations bounded over 86 blocks; 10 fit
# steps
EDSR86_L, EDSR86_RS, EDSR86_STEPS = 86, 0.1, 10
EDSR86_ARGS = ['--n_resblocks', str(EDSR86_L), '--res_scale',
               str(EDSR86_RS)]
# per step: K1 each way per block; K2, K3 and the weight grads as
# EDSR-baseline's
EDSR86_STEP_LAUNCHES = {**STEP_LAUNCHES, trunk_fwd: EDSR86_L,
                        trunk_bwd: EDSR86_L}
# EDSR's paper configuration (Lim et al. 2017, the reference's EDSR): 256
# features, 32 resblocks, res_scale 0.1. Past 96 features srtpu runs its
# trunk and tail on XLA, so the port runs stock ops there (ROADMAP F10):
# no kernel of the port, forward or backward
EDSR_BIG_ARGS = ['--n_feats', '256', '--n_resblocks', '32', '--res_scale',
                 '0.1']
EDSR_BIG_STEPS = 10
NO_KERNEL = {k: 0 for k in (
    trunk_fwd, trunk_bwd, conv3x3_fwd, conv3x3_bwd, K2G_FWD, K2G_BWD, upsample_fwd, upsample_bwd, conv_wgrad,
    WGG, resblock_fused_fwd, resblock_bwd_fused)}
# Phase 2j. K1 over 86 blocks (res_scale 0.1): a value a bf16 step apart
# in one block's output is carried on by the skips, as in K1's 16-block
# trunk (four steps): the forward's out, xs, h1s and the backward's dx
# within eight steps of their largest magnitude, and the kernel's error
# against the unrounded f32 trunk no more than twice the plain path's;
# the weight grads one step (they read the bf16 dh1 chain). K1 at one
# block: every bf16 output within one step, the f32 grads one step. K6 at
# one RDN-B block: as K6's trunk (two steps; the chain's as K6B_STEPS).
# K9c, each dense layer: K2's (one step; dW and db 1e-4). K9d: dx within
# one step, its f32 dW and db within 1e-4 of their largest magnitude
# (f32 sums of f32 products in another order).
K1S_STEPS, K1S_DW_STEPS = 8, 1
# Phase 2b holds K1 at these res_scales (0.1: EDSR 64 x 86's and phase
# 2j's resblock_cs'); phase 2m times K1 at (blocks, res_scale, batch, H,
# W): EDSR-baseline's trunk at the training shape and at LR 128x128, EDSR
# 64 x 86's and one block (resblock_cs), each held within the limits of
# its depth (16: 2b's; 86: K1S_STEPS; 1: one step)
K1_SCALES = (1.0, 0.1)
K1_TIMED = ((L, 1.0, TRAIN_BATCH, 32, 32), (L, 1.0, 1, 128, 128),
            (EDSR86_L, EDSR86_RS, TRAIN_BATCH, 32, 32),
            (1, EDSR86_RS, TRAIN_BATCH, 32, 32))
# the op runs of phase 2j: EDSR True's training shape (K9d, resblock_cs),
# RDN-B's trunk at the training shape (the calls trunk, K9c)
K9D_SCALES = (1.0, 0.1)
# The H100 SXM's published peaks (NVIDIA data sheet), for bound_ms
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
# Phase 24, SRCNN x4: no kernel of the port runs (its bicubic is two f32
# matmuls and its three convs are cuDNN's, as srtpu leaves them to XLA)
SRCNN_LAUNCHES = {**NO_KERNEL, rcab_fwd: 0, rcab_bwd: 0}
# Phase 25, validate: an eval set of HR 512x512, 1000x680 (LR 250x170,
# bucket-padded to 256x192: the mask takes the padding out) and 2048x1408
# (LR 128x128, 250x170 and 512x352, phase 3's sizes), scored with srtpu's
# three full-reference metrics the port has
VAL_HR_SIZES = ((512, 512), (1000, 680), (2048, 1408))
VAL_METRICS = ('PSNR', 'SSIM', 'MS-SSIM')
# The kernel path's metrics against the plain path's, per image: their SR
# images differ within SLICE_MAX_TOL / SLICE_MEAN_TOL (a bf16 step here
# and there), which moves a mean square error or an SSIM mean by far
# less than these
VAL_PATH_TOL = {'PSNR': 0.02, 'SSIM': 2e-3, 'MS-SSIM': 2e-3}
# The card's metric functions against the same functions on the CPU, on
# the same f32 SR and HR: the same elementwise f32 arithmetic, the means
# reduced in another order; and masked (padded) against unpadded
METRIC_DEVICE_TOL = {'PSNR': 1e-4, 'SSIM': 1e-5, 'MS-SSIM': 1e-5}
# Phase 26, the tiled steps: srtpu's TPU routing (eval_tile 80, overlap 8,
# batches of 16 tiles) and the host tiles (predict_tile 128, overlap 32)
TILE, TILE_OVERLAP, TILE_BATCH = 80, 8, 16
HOST_TILE, HOST_OVERLAP = 128, 32
TILE_ARGS = ['--eval_tile', str(TILE), '--eval_tile_overlap',
             str(TILE_OVERLAP)]
# srtpu's bf16 tile seams against its direct forward (ROADMAP.md F2)
F2_SEAM = 3e-3


# Phase 27, fit with validation: 4 epochs of 5 steps (80 training
# images), val every 2 epochs on HR 512x512 and 1000x680, the sanity pass
# on both; the crash at the start of epoch 3
FITVAL_EPOCHS, FITVAL_SPE, FITVAL_CRASH_STEP = 4, 5, 10
PHASE4_STEP_MS: dict = {}   # each model's first kernel-path step ms
FITVAL_HR_SIZES = VAL_HR_SIZES[:2]
FITVAL_PASSES = 3


def k1_held() -> set:
    """(kind, blocks, save, res_scale) of the K1 calls phases 2, 2b, 2j
    and 2m hold against their plain versions on the card ('fwd': the
    forward saving or not; 'chain': the backward)."""
    held = {('fwd', L, False, 1.0)}
    for s in K1_SCALES:
        held |= {('fwd', L, True, s), ('fwd', L, False, s),
                 ('chain', L, False, s)}
    for nb in (EDSR86_L, 1):
        held |= {('fwd', nb, True, EDSR86_RS), ('chain', nb, False,
                                                EDSR86_RS)}
    for nb, s, *_ in K1_TIMED:
        held |= {('fwd', nb, True, s), ('fwd', nb, False, s),
                 ('chain', nb, False, s)}
    return held


def k7_held() -> set:
    """(kind, C, blocks, save, res_scale) of the K7 calls phase 2g holds
    against their plain versions on the card ('fwd'; 'bwd' from the
    forward's saved block inputs and h2), and K8c's in 2i ('k8c')."""
    held = {('fwd', WDSR_C, 1, False, 1.0), ('bwd', WDSR_C, 1, False, 1.0),
            ('k8c', WDSR_C, 1, False, 1.0)}
    for s in K7_SCALES:
        held |= {('fwd', WDSR_C, WDSR_L, True, s),
                 ('fwd', WDSR_C, WDSR_L, False, s),
                 ('bwd', WDSR_C, WDSR_L, False, s)}
    return held


def k8a_held() -> set:
    """(kind, blocks, save, res_scale) of the K8a calls phases 2i and 2j
    hold against their plain versions on the card: the per-block op
    ('block', saving h1) at res_scale 1 (2i) and at K9D_SCALES (2j's K9d
    and ``resblock_fused_v3`` runs); the trunk op ('trunk') at L blocks,
    saving and not (2i)."""
    held = {('block', 1, True, s) for s in (1.0, *K9D_SCALES)}
    held |= {('trunk', L, save, 1.0) for save in (False, True)}
    return held


def k9d_held() -> set:
    """(kind, res_scale) of the K9d calls phase 2j holds against its
    plain version on the card: the wrapper alone ('kernel') at
    K9D_SCALES and under ``resblock_fused_v3``'s op run ('op', at 0.1).
    ``ops.resblock.bwd_plan`` of the res_scale is each one's plan."""
    return {('kernel', s) for s in K9D_SCALES} | {('op', 0.1)}


def k3_held() -> set:
    """(kind, r, batch, H, W at the LR) of the K3 calls phases 2 and 2b
    hold against their plain versions on the card: the forward ('fwd') at
    KERNEL_SIZES (batch 1) and at the x8 path's second stage (twice each
    size), the backward ('bwd') at BWD_SIZES and their second stages."""
    held = set()
    for h, w in KERNEL_SIZES:
        held |= {('fwd', 2, 1, h, w), ('fwd', 2, 1, 2 * h, 2 * w)}
    for bsz, h, w in BWD_SIZES:
        held |= {('bwd', 2, bsz, h, w), ('bwd', 2, bsz, 2 * h, 2 * w)}
    return held


def k4_held() -> set:
    """(kind, blocks, reflect) of the K4 / K4r calls phases 2d, 2h and 2n
    hold against their plain versions on the card: each per-function
    wrapper ('f1' ... 'b3'; blocks None) with SAME boundaries (2d) and
    the four that take reflect with REFLECT (2h); the trunk op each way
    ('trunk_fwd', 'trunk_bwd') at L blocks, both modes (2n)."""
    held = {(k.lower(), None, False) for k in K4_FNS}
    held |= {(k.lower(), None, True) for k in K4R}
    for rf in (False, True):
        held |= {('trunk_fwd', L, rf), ('trunk_bwd', L, rf)}
    return held


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


def graph_ms(fn, calls: int = 20, windows: int = 5) -> float:
    """Median over ``windows`` of the CUDA-event time of one replay of a
    CUDA graph of ``calls`` calls of ``fn``, per call: the device's time
    alone. Back-to-back calls (:func:`median_ms`) measure the host's
    enqueue instead where a kernel is faster than its wrapper."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return float(sorted(times)[len(times) // 2])


def host_ms(fn, calls: int = 7) -> float:
    """Median host time of one call of ``fn`` with the device idle before
    it: the wrapper's checks, allocations and launches (its enqueue)."""
    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
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
                'library_ms': None, 'library_bench_ms': None} for k in kids}


def lib_ms(lib) -> tuple[float, float]:
    """A library call's ms as configured here (cuDNN's heuristics pick
    the algorithm) and with ``torch.backends.cudnn.benchmark`` on (cuDNN
    times its algorithms at the first call of a shape and keeps the
    fastest), the setting restored after."""
    heuristic = median_ms(lib)
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        bench = median_ms(lib)
    finally:
        torch.backends.cudnn.benchmark = before
    return heuristic, bench


def add_lib(st: dict, times: tuple[float, float]) -> None:
    """Add a library call's (heuristic, benchmark) ms to ``st``."""
    for key, v in zip(('library_ms', 'library_bench_ms'), times):
        st[key] = (st[key] or 0.0) + v


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
        add_lib(st, lib_ms(lib))


def bwd_split(st: dict, x, w, g, smi: str, tag: str) -> None:
    """K2's backward as its two launches, each timed beside its bound and
    added to ``st``: dx (``conv3x3_dx``, the engine on the forward
    weight) and the weight grads (dW, db)."""
    k, cin, cout = w.shape[0], w.shape[-2], w.shape[-1]
    px = x.shape[0] * x.shape[1] * x.shape[2]
    dx = conv3x3_dx(g, w)
    dw = conv_wgrad(x, g, k=k)
    dx_ms = median_ms(lambda: conv3x3_dx(g, w))
    wg_ms = median_ms(lambda: conv_wgrad(x, g, k=k))
    dx_b = max(bound(conv_flops(px, cout, cin, k), nbytes(g, w, dx)))
    wg_b = max(bound(conv_flops(px, cin, cout, k), nbytes(x, g, dw)))
    wg_lib = lib_ms(lib_wgrad(x[None], g[None], k))
    for key, v in (('dx_ms', dx_ms), ('dx_bound_ms', dx_b),
                   ('wgrad_ms', wg_ms), ('wgrad_bound_ms', wg_b),
                   ('wgrad_library_ms', wg_lib[0]),
                   ('wgrad_library_bench_ms', wg_lib[1])):
        st[key] = st.get(key, 0.0) + v
    print(f'{tag} split: dx {dx_ms:.4f} ms (bound {dx_b:.5f}) | weight '
          f'grads {wg_ms:.4f} ms (bound {wg_b:.5f}; conv2d_weight '
          f'{wg_lib[0]:.4f} / benchmark {wg_lib[1]:.4f})  [{smi}]')


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


def kernel_cases(h: int, w: int, device, bsz: int = 1) -> list[tuple]:
    """(kernel id, label, wrapper, plain, args, matrix FLOPs, library
    call or None) at the shapes predict gives each kernel for a batch of
    ``bsz`` h x w LR images (phase 26: the tiled steps' batches)."""
    gen = torch.Generator().manual_seed(h * 1000 + w + (bsz - 1) * 7)
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
    n = bsz
    trunk = (act(n, h, w, C), w1, b1, w2, b2, 1.0)
    close = (act(n, h, w, C), *conv(C, C))
    ups = (act(n, h, w, C), *conv(C, 4 * C), 2)
    pm = (act(n, 2 * h, 2 * w, C), *conv(C, 4 * C))
    pd = (act(n, 2 * h, 2 * w, 4 * C), *conv(4 * C, 16))
    # SRResNet's phase-dense 9x9 output conv: 5x5, 256 -> 16
    w5 = _uniform(gen, (5, 5, 4 * C, 16), (25 * 4 * C) ** -0.5, device, bf)
    pd5 = (act(n, 2 * h, 2 * w, 4 * C), w5,
           _uniform(gen, (16,), 0.05, device, torch.float32))
    at = '' if n == 1 else f'{n} x '
    return [
        ('K1', f'trunk L={L} {at}{h}x{w}', trunk_fwd, trunk_plain, trunk,
         2 * L * conv_flops(n * h * w, C, C), None),
        ('K2', f'close 64->64 {at}{h}x{w}', conv3x3_fwd, conv3x3_plain,
         close, conv_flops(n * h * w, C, C), lib_conv(*close)),
        ('K3', f'upsample r=2 {at}{h}x{w}', upsample_fwd, upsample_plain,
         ups, conv_flops(n * h * w, C, 4 * C), None),
        ('K2', f'phase-major 64->256 {at}{2 * h}x{2 * w}', conv3x3_fwd,
         conv3x3_plain, pm, conv_flops(4 * n * h * w, C, 4 * C),
         lib_conv(*pm)),
        ('K2', f'phase-dense 256->16 {at}{2 * h}x{2 * w}', conv3x3_fwd,
         conv3x3_plain, pd, conv_flops(4 * n * h * w, 4 * C, 16),
         lib_conv(*pd)),
        ('K25', f'phase-dense 5x5 256->16 {at}{2 * h}x{2 * w}', conv3x3_fwd,
         conv3x3_plain, pd5, conv_flops(4 * n * h * w, 4 * C, 16, 5),
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
    # the x8 path's second stage: K3 at twice each LR size
    for h, w in KERNEL_SIZES:
        gen = torch.Generator().manual_seed(2000 * h + 2 * w)
        args = (_uniform(gen, (1, 2 * h, 2 * w, C), 1.0, device,
                         torch.bfloat16),
                _uniform(gen, (3, 3, C, 4 * C), (9 * C) ** -0.5, device,
                         torch.bfloat16),
                _uniform(gen, (4 * C,), (9 * C) ** -0.5, device,
                         torch.float32), 2)
        err = _k3_hold(f'K3 upsample r=2, the x8 second stage, {2 * h}x'
                       f'{2 * w}', upsample_fwd, upsample_plain, args,
                       (TOL_STEPS['K3'],))
        stats['K3']['max_abs_err'] = max(stats['K3']['max_abs_err'], err)
    return stats


def _k3_hold(tag: str, fn, plain, args, steps) -> float:
    """K3 (``fn``) against its plain version on ``args``, each output
    within its ``steps`` (bf16 steps of its largest magnitude; None: 1e-4
    of it), two calls bit-identical; returns the first output's error."""
    got = _as_list(fn(*args))
    torch.cuda.synchronize()
    _same_twice(lambda: fn(*args), got, tag)
    return _check_all(tag, ('out',) if len(got) == 1 else ('dx', 'dW', 'db'),
                      got, _as_list(plain(*args)), steps)


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


def check_bwd_kernels(device, smi: str) -> dict:
    """Phase 2b. Returns per kernel id: max dx error (the weight-grad
    kernel: max dW error) over all shapes, and kernel / plain / bound /
    library ms summed over its uses at the training shapes."""
    stats = new_stats(('K1sv', 'K1b', 'K2b', 'K3b', 'W', 'K25b'))
    for i, (bsz, h, w) in enumerate(BWD_SIZES):
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
            stats['K1sv']['max_abs_err'] = max(stats['K1sv']['max_abs_err'],
                                               err)
        if i == 0:
            st = stats['K1sv']
            record(st, median_ms(lambda: trunk_fwd(*args, save=True)),
                   median_ms(lambda: trunk_plain(*args, save=True)),
                   2 * L * conv_flops(bsz * h * w, C, C), nbytes(args, got))
            print(f'K1s trunk fwd, saving, L={L} {bsz}x{h}x{w}: kernel '
                  f'{st["ms"]:.4f} ms plain {st["plain_ms"]:.4f} ms')
        # K1 at res_scale 0.1 beside 1.0, within the same limits
        rs = K1_SCALES[1]
        _k1_hold((*args[:5], rs),
                 _uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16),
                 (TOL_STEPS['K1'], BWD_DX_STEPS['K1'], BWD_DW_STEPS['K1']),
                 f'K1 trunk L={L} res_scale {rs} {bsz}x{h}x{w}')
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
                if kid in ('K2b', 'K25b'):
                    bwd_split(st, *args, smi, f'{kid} {label}')
    # the x8 path's second stage: K3's backward at twice each LR size
    cb = (9 * C) ** -0.5
    for bsz, h, w in BWD_SIZES:
        gen = torch.Generator().manual_seed(bsz * 20011 + h * 101 + w)
        args = (_uniform(gen, (bsz, 2 * h, 2 * w, C), 1.0, device,
                         torch.bfloat16),
                _uniform(gen, (3, 3, C, 4 * C), cb, device, torch.bfloat16),
                _uniform(gen, (bsz, 4 * h, 4 * w, C), 1.0, device,
                         torch.bfloat16), 2)
        err = _k3_hold(f'K3b upsample bwd r=2, the x8 second stage, '
                       f'{bsz}x{2 * h}x{2 * w}', upsample_bwd,
                       upsample_bwd_plain, args,
                       (BWD_DX_STEPS['K3'], 1e-4, 1e-4))
        stats['K3b']['max_abs_err'] = max(stats['K3b']['max_abs_err'], err)
        del args
    torch.cuda.empty_cache()
    return stats


def _k3_times(device, smi: str, stats: dict) -> None:
    """K3's device time alone (a CUDA graph of its calls), CUDA-event time
    and host time a call: the forward at LR 128x128 (the K3 row) and at
    the training shape, the backward and its dx alone (``upsample_dx``)
    at the training shape (the K3b row), each beside cuDNN's calls for
    the same work (bf16, channels-last): ``F.conv2d`` 64 -> 256 with its
    bias, then ``F.pixel_shuffle``; ``aten.convolution_backward`` of that
    conv (dx, dW, db) at the coarse cotangent."""
    bf, f32 = torch.bfloat16, torch.float32
    cb = (9 * C) ** -0.5
    gen = torch.Generator().manual_seed(4243)
    wt = _uniform(gen, (3, 3, C, 4 * C), cb, device, bf)
    b = _uniform(gen, (4 * C,), cb, device, f32)
    w_pm = w_pm_hwio(wt, 2).contiguous()
    for bsz, h, w in ((1, 128, 128), BWD_SIZES[0]):
        x = _uniform(gen, (bsz, h, w, C), 1.0, device, bf)
        conv = lib_conv(x, wt, b)
        fns = {'fwd': lambda: upsample_fwd(x, wt, b, 2),
               'cuDNN reference fwd (F.conv2d + F.pixel_shuffle)':
                   lambda: F.pixel_shuffle(conv(), 2)}
        train = bsz == TRAIN_BATCH
        if train:
            g = _uniform(gen, (bsz, 2 * h, 2 * w, C), 1.0, device, bf)
            fns.update({
                'bwd (dx + weight grads)': lambda: upsample_bwd(x, wt, g, 2),
                'dx alone': lambda: upsample_dx(g, w_pm, 2),
                'cuDNN reference bwd (convolution_backward)': lib_conv_bwd(
                    x, wt, pm_from_fine(g, 2).contiguous())})
        times = {}
        for name, fn in fns.items():
            times[name] = (graph_ms(fn), median_ms(fn), host_ms(fn))
            d, e, hh = times[name]
            print(f'K3 {name} {bsz}x{h}x{w}: device {d:.4f} ms, CUDA events '
                  f'{e:.4f} ms, host {hh:.4f} ms a call  [{smi}]', flush=True)
        ref = times['cuDNN reference fwd (F.conv2d + F.pixel_shuffle)']
        if not train:
            stats['K3'].update(device_ms=times['fwd'][0],
                               host_ms=times['fwd'][2], reference_ms=ref[1],
                               reference_device_ms=ref[0])
            continue
        ref = times['cuDNN reference bwd (convolution_backward)']
        stats['K3b'].update(
            device_ms=times['bwd (dx + weight grads)'][0],
            host_ms=times['bwd (dx + weight grads)'][2],
            dx_device_ms=times['dx alone'][0], reference_ms=ref[1],
            reference_device_ms=ref[0])
    torch.cuda.empty_cache()


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


def _k1_hold(args, g, steps, tag: str) -> tuple:
    """K1 on ``args`` (trunk_fwd's) and the cotangent ``g`` against the
    plain versions: the forward saving (out, xs, h1s within steps[0]),
    the forward without saving (bit-identical to the saving one's out),
    the backward (dx within steps[1], the f32 weight grads steps[2]); two
    calls bit-identical. Returns the backward's arguments."""
    got = trunk_fwd(*args, save=True)
    torch.cuda.synchronize()
    _same_twice(lambda: trunk_fwd(*args, save=True), got, f'{tag} fwd')
    need(torch.equal(trunk_fwd(*args), got[0]),
         f'{tag}: the forward without saving differs from the saving one')
    _check_all(f'{tag} fwd (saving)', ('out', 'xs', 'h1s'), got,
               trunk_plain(*args, save=True), [steps[0]] * 3)
    bargs = (got[1], got[2], g, args[1], args[3], args[5])
    bgot = trunk_bwd(*bargs)
    torch.cuda.synchronize()
    _same_twice(lambda: trunk_bwd(*bargs), bgot, f'{tag} bwd')
    _check_all(f'{tag} bwd', ('dx', 'dW1', 'db1', 'dW2', 'db2'), bgot,
               trunk_bwd_plain(*bargs), [steps[1]] + [steps[2]] * 4)
    return bargs


def _k5_parts(tag: str, fwd, bwd, smi: str) -> None:
    """K5's device time by part (torch.profiler), a call of ``fwd`` and of
    ``bwd``: the forward's conv pair (K2's engine) and passes (pool + MLP,
    gate); the backward's passes (pool sums, MLP, dr2), dx chain (the
    engine's two transposed convs) and weight grads (W)."""
    parts = {'fwd conv pair': (fwd, ('conv_sm90_kernel',)),
             'fwd passes': (fwd, ('rcab_',)),
             'bwd passes': (bwd, ('rcab_',)),
             'bwd dx chain': (bwd, ('conv_sm90_kernel',)),
             'bwd weight grads': (bwd, ('wgrad',))}
    print(f'K5 {tag} device ms by part (torch.profiler): ' + ', '.join(
        f'{k} {_kernel_device_ms(fn, names):.4f}'
        for k, (fn, names) in parts.items()) + f'  [{smi}]')


def check_rcab_kernels(device, smi: str) -> dict:
    """Phase 2c. K5's forward (saving) and backward against the plain
    versions, one RCAB at the training, predict and ragged shapes and a
    16-block group at the training shape (K5_SHAPES, K5_GROUPS); the
    forward without saving bit-identical to the saving one's output; two
    calls bit-identical. Returns K5 / K5b stats, timed at the training
    shape (per RCAB call; device time by part)."""
    stats = new_stats(('K5', 'K5b'))
    mlp_tol = [RCAB_MLP_REL] * 4
    bwd_names = ('dx', 'dw1', 'db1', 'dw2', 'db2', 'dwd', 'dbd', 'dwu', 'dbu')
    for i, (bsz, h, w) in enumerate(K5_SHAPES):
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
        need(torch.equal(rcab_fwd(x, *prm), got[0]),
             f'K5 fwd {tag}: without saving, another output')
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
            # the device's time alone (CUDA graphs): back-to-back calls
            # measure the host where the kernels are faster than it
            for kid, fn in (('K5', lambda: rcab_fwd(x, *prm, save=True)),
                            ('K5b', lambda: rcab_bwd(*bargs))):
                stats[kid]['device_ms'] = graph_ms(fn)
                stats[kid]['host_ms'] = host_ms(fn)
                print(f'{kid} {tag}: device {stats[kid]["device_ms"]:.4f} ms '
                      f'a call, host {stats[kid]["host_ms"]:.4f} ms')
            _k5_parts(tag, lambda: rcab_fwd(x, *prm, save=True),
                      lambda: rcab_bwd(*bargs), smi)

    # a 16-block residual group at the training shape
    bsz, h, w = K5_SHAPES[0]
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
    need(torch.equal(resgroup_fwd(x, *prm), got[0]),
         f'group fwd {tag}: without saving, another output')
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
    fns = {'fwd saving': lambda: resgroup_fwd(x, *prm, save=True),
           'fwd predict': lambda: resgroup_fwd(x, *prm),
           'bwd': lambda: resgroup_bwd(*bargs)}
    plain = {'fwd saving': lambda: resgroup_plain(x, *prm, save=True),
             'bwd': lambda: resgroup_bwd_plain(*bargs)}
    print(f'K5 group {tag} (with its close conv; bwd with the weight '
          f'grads), ms a call: ' + '; '.join(
              f'{k} kernel {median_ms(fn, 5, 3):.4f}, device '
              f'{graph_ms(fn, 5, 3):.4f}, host {host_ms(fn):.4f}'
              + (f', plain {median_ms(plain[k], 5, 3):.4f}' if k in plain
                 else '') for k, fn in fns.items()) + f'  [{smi}]')
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
    """The kernel path's B2 replaced by ``fault`` of it inside the block:
    the trunk op's kernel path runs there as calls of the per-function
    kernels in its order (bn_block.trunk_fwd_calls and trunk_bwd_calls
    over KERNELS), whose B2 is the fault."""
    b2 = bn_block.KERNELS['b2']
    fwd, bwd = bn_block.bn_trunk_fwd, bn_block.bn_trunk_bwd
    bn_block.KERNELS['b2'] = fault(b2)
    bn_block.bn_trunk_fwd = functools.partial(bn_block.trunk_fwd_calls,
                                              bn_block.KERNELS)
    bn_block.bn_trunk_bwd = functools.partial(bn_block.trunk_bwd_calls,
                                              bn_block.KERNELS)
    try:
        yield
    finally:
        bn_block.KERNELS['b2'] = b2
        bn_block.bn_trunk_fwd, bn_block.bn_trunk_bwd = fwd, bwd


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
    """Inside the block, each block's BN2 backward dy (f32) and that dy's
    invariants per channel, (mean(dy), mean(dy * xhat2)) as (2, C), are
    appended to ``store`` (blocks L-1 ... 0): on the plain path
    (bn_block.PLAIN) from each call of its B2, on the kernel path
    (bn_block.KERNELS) from the dy that each trunk-op backward returns (a
    planted fault's included). No-op for None."""
    if store is None:
        yield
        return

    def add(dy, y2, st2):
        dy = dy.float()
        xh = bn_block._xhat(y2, st2)
        store.append((dy, torch.stack([dy.mean((0, 1, 2)),
                                       (dy * xh).mean((0, 1, 2))])))
    if table is bn_block.PLAIN:
        saved = table['b2']

        def call(g, y2, st2, *rest):
            out = saved(g, y2, st2, *rest)
            add(out[1], y2, st2)
            return out
        table['b2'] = call
        try:
            yield
        finally:
            table['b2'] = saved
        return
    trunk = bn_block.bn_trunk_bwd

    def trunk_call(acts, ys, sts, *rest, **kw):
        out = trunk(acts, ys, sts, *rest, **kw)
        for i in reversed(range(out[1].shape[0] // 2)):
            add(out[1][2 * i + 1], ys[2 * i + 1], sts[2 * i + 1])
        return out
    bn_block.bn_trunk_bwd = trunk_call
    try:
        yield
    finally:
        bn_block.bn_trunk_bwd = trunk


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


def check_bn_kernels(device, smi: str) -> dict:
    """Phase 2d. K4's six functions against their plain versions at the
    training shape and a ragged one (per-element limits of
    bn_block.kernel_limits; a db summed from the bf16 dy shown to fail
    them), two calls bit-identical, times at the training shape: each
    function's device time alone (a CUDA graph of its calls), its host
    time a call and the plain version's time. Returns per-function
    stats."""
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
                dev_ms = graph_ms(lambda: fn(*args))
                host = host_ms(lambda: fn(*args))
                plain_ms = median_ms(lambda: K4_PLAIN[kid](*args))
                print(f'K4 {kid} {tag}: device {dev_ms:.4f} ms (a CUDA graph '
                      f'of its calls), host {host:.4f} ms a call; plain '
                      f'{plain_ms:.4f} ms  [{smi}]')
                record(st, dev_ms, plain_ms, flops, nbytes(args, got))
                st['device_ms'], st['host_ms'] = dev_ms, host
    return stats


def _trunk_model(device, reflect: bool):
    """SRResNet's BN trunk (16 blocks + close, 64 channels) from seed 7,
    with REFLECT boundaries (SRGAN's) or SAME, its BN scales moved off
    their init (seed 8)."""
    trunk = create_model('SRResNet', scale_factor=SCALE, n_feats=C,
                         n_resblocks=L, dtype=torch.bfloat16, device=device,
                         generator=torch.Generator().manual_seed(7)).trunk
    trunk.reflect = reflect
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for name in ('bn1_scale', 'bn2_scale', 'close_bn_scale'):
            getattr(trunk, name).add_(
                _uniform(gen, getattr(trunk, name).shape, 0.5, device,
                         torch.float32))
    return trunk, gen


def bn_trunk_by_blocks(m, x, dtype, plain: bool = False):
    """A BNTrunk ``m``'s train-mode forward with its blocks called one by
    one through the per-function wrappers (bn_block.bn_resblock a block,
    then bn_close; ``plain``: their plain versions), the running
    statistics updated by the module's own rule: what the trunk op is held
    against here and in the tests."""
    xd, rf = x.to(dtype).contiguous(), m.reflect
    u, stats = xd, []
    for prm in m._blocks():
        u, st = bn_block.bn_resblock(u, *prm, plain=plain, reflect=rf)
        stats.append(st)
    out, (mc, vc) = bn_block.bn_close(
        u, xd, m.close_w, m.close_b, m.close_bn_scale, m.close_bn_bias,
        plain=plain, reflect=rf)
    m.update_running(*(torch.stack(s) for s in zip(*stats)), mc, vc)
    return out


def check_bn_trunk(device, smi: str) -> dict:
    """Phase 2n. K4's and K4r's trunk op (bn_block.bn_trunk_fwd and
    bn_trunk_bwd: 16 blocks + the close in one host call each way, the
    33 weight grads in one launch of W) at the training shape, train
    mode, SAME and REFLECT: forward and backward through the model's
    trunk, the kernel path and the plain path (both bf16) held to the
    unrounded f32 path (every grad within BN_TRUNK_VS_F32 times the plain
    path's error, each block's BN2 dy and its invariants, _dy_rows), the
    running statistics kernel vs plain, two planted faults in B2 caught,
    two calls bit-identical, and the trunk op against the per-function
    kernels block by block (bn_trunk_by_blocks: the same bits but for
    the weight grads, whose W split differs with the job count: 1e-4 of
    their largest magnitude); the trunk op's device time each way (a
    CUDA graph) and host time a call, the plain trunk's time. Returns the
    stats of K4t, K4tb (SAME) and K4rt, K4rtb (REFLECT)."""
    stats = new_stats(('K4t', 'K4tb', 'K4rt', 'K4rtb'))
    bsz, h, w = TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE
    for rf in (False, True):
        trunk, gen = _trunk_model(device, rf)
        x = _uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16)
        g = _uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16)

        def run(dtype, plain, rec, by_blocks=False):
            m = copy.deepcopy(trunk).train()
            xi = x.to(dtype).clone().requires_grad_()
            with _dy_record(bn_block.PLAIN if plain else bn_block.KERNELS,
                            rec):
                out = (bn_trunk_by_blocks(m, xi, dtype, plain) if by_blocks
                       else m(xi, dtype, plain))
                out.backward(g.to(dtype))
            return m, {'out': out, 'dx': xi.grad,
                       **{n: p.grad for n, p in m.named_parameters()}}

        scales, rk, rp, rf32 = {}, [], [], []
        mk, tk = run(torch.bfloat16, False, rk)
        mp, tp = run(torch.bfloat16, True, rp)
        with _db_scales(scales):
            _, tf = run(torch.float32, True, rf32)
        torch.cuda.synchronize()
        rows = _vs_f32(tk, tp, tf, scales)
        dy_rows = _dy_rows(rk, rp, rf32)
        kind = 'K4r' if rf else 'K4'
        label = (f'{kind} trunk op L={L} + close {bsz}x{h}x{w}, fwd and '
                 f'bwd')
        print(f'{label}, max_abs vs the f32 path, kernel/plain/tol (|f32|): '
              + ', '.join(t for _, t in rows) + '; per block, error/limit: '
              + ', '.join(f'{t} = {r:.4g}' for r, t in dy_rows))
        rows = sorted(rows + dy_rows, key=lambda r: -r[0])
        need(all(r <= 1.0 for r, _ in rows),
             f'{label}: ' + '; '.join(t for r, t in rows if not r <= 1.0))
        bk, bp = dict(mk.named_buffers()), dict(mp.named_buffers())
        _check_all(f'{kind} trunk op running statistics, kernel vs plain',
                   list(bk), list(bk.values()), list(bp.values()),
                   [BN_TRUNK_STAT_REL] * len(bk))
        for what, fault in PLANTED.items():
            bad_dy = []
            with _planted(fault):
                _, bad = run(torch.bfloat16, False, bad_dy)
            _catches(_vs_f32(bad, tp, tf, scales)
                     + _dy_rows(bad_dy, rp, rf32), what, label)
        mk2, tk2 = run(torch.bfloat16, False, None)
        need(all(torch.equal(tk[n], tk2[n]) for n in tk) and all(
            torch.equal(a, b) for a, b in zip(mk.buffers(), mk2.buffers())),
             f'{label}: two calls differ')
        mb, tb = run(torch.bfloat16, False, None, by_blocks=True)
        weights = ('w1', 'w2', 'close_w')
        same = [n for n in tk if n not in weights]
        need(all(torch.equal(tk[n], tb[n]) for n in same) and all(
            torch.equal(a, b) for a, b in zip(mk.buffers(), mb.buffers())),
             f'{label}: the trunk op differs from its blocks called one by '
             'one: ' + ', '.join(n for n in same
                                 if not torch.equal(tk[n], tb[n])))
        worst = max(((tk[n] - tb[n]).abs().max() / tb[n].abs().max()).item()
                    for n in weights)
        print(f'{label}: against its blocks called one by one (the '
              f'per-function kernels): out, dx, running statistics and '
              f'every grad but the conv weights\' bit for bit; the weight '
              f'grads (W split over 33 jobs, not 1) within {worst:.3g} of '
              f'their largest magnitude (tol 1e-4)  [{smi}]')
        need(worst <= 1e-4, f'{label}: weight grads against its blocks')

        # the trunk op alone, each way, on the model's parameters
        m = trunk
        prm = [m.w1, m.b1, m.bn1_scale, m.bn1_bias, m.alpha, m.w2, m.b2,
               m.bn2_scale, m.bn2_bias, m.close_w, m.close_b,
               m.close_bn_scale, m.close_bn_bias]
        bf = torch.bfloat16
        fargs = [t.detach().to(bf if t.dim() >= 4 else torch.float32)
                 .contiguous() for t in prm]
        fwd = lambda: bn_trunk_fwd(x, *fargs, reflect=rf)  # noqa: E731
        out, acts, ys, sts = fwd()
        bargs = (acts, ys, sts, g, fargs[0], fargs[5], fargs[9], fargs[2],
                 fargs[7], fargs[11], fargs[4])
        bwd = lambda: bn_trunk_bwd(*bargs, reflect=rf)  # noqa: E731
        pf = lambda: bn_block.bn_trunk_fwd_plain(  # noqa: E731
            x, *fargs, reflect=rf)
        pb = lambda: bn_block.bn_trunk_bwd_plain(  # noqa: E731
            *bargs, reflect=rf)
        px = bsz * h * w
        cf = (2 * L + 1) * conv_flops(px, C, C)
        for key, fn, plain, flops, moved in (
                ('t', fwd, pf, cf, nbytes(x, fargs, out, acts, ys, sts)),
                ('tb', bwd, pb, 2 * cf, nbytes(bargs, fargs, bwd()))):
            kid = kind + key
            dev_ms = graph_ms(fn, 3, 3)
            host = host_ms(fn)
            plain_ms = median_ms(plain, 2, 3)
            st = stats[kid]
            record(st, dev_ms, plain_ms, flops, moved)
            st['device_ms'], st['host_ms'] = dev_ms, host
            st['max_abs_err'] = max(
                st['max_abs_err'],
                (tk['out'] - tp['out']).float().abs().max().item()
                if key == 't' else
                (tk['dx'] - tp['dx']).float().abs().max().item())
            print(f'{kid} (trunk op, {"bwd" if key == "tb" else "fwd"}, '
                  f'L={L} + close) {bsz}x{h}x{w}: device {dev_ms:.4f} ms (a '
                  f'CUDA graph; {dev_ms / (L + 1):.5f} a conv pair), host '
                  f'{host:.4f} ms a call, plain {plain_ms:.4f} ms, bound '
                  f'{st["bound_ms"]:.5f} ms  [{smi}]', flush=True)
        del acts, ys, sts, bargs
        torch.cuda.empty_cache()
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
                dev_ms = graph_ms(lambda: fn(*args))
                same_ms = graph_ms(lambda: fn(*args[:-1], False))
                host = host_ms(lambda: fn(*args))
                plain_ms = median_ms(lambda: plain(*args))
                print(f'K4r {kid} {tag}: device {dev_ms:.4f} ms (a CUDA '
                      f'graph of its calls) against K4 (SAME) {same_ms:.4f} '
                      f'ms on the same inputs = {dev_ms / same_ms:.3f}x; host '
                      f'{host:.4f} ms a call; plain {plain_ms:.4f} ms  '
                      f'[{smi}]')
                record(st, dev_ms, plain_ms, flops, nbytes(args, got))
                st['device_ms'], st['host_ms'] = dev_ms, host

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


def rdn_reference(buf, wpk_l, b_l, wf_l, bf_l, g) -> tuple:
    """cuDNN's calls for the work of one K6 block (bf16, channels-last;
    no PyTorch call computes K6's function, so this is a target, not a
    library time): the forward's eight dense-layer convs (c_in 64 (i +
    1) -> 64 on the buffer's prefix, copied contiguous) and the 576 -> 64
    1x1 fusion, and their ``convolution_backward`` (dx, dW, db) at the
    cotangent g, and the weight grads alone (``conv2d_weight``, the pair
    weight grads' work). buf: the block's buffer (B, H, W, c_tot); wpk_l,
    b_l, wf_l, bf_l: its packed weights, biases, fusion weight and
    bias."""
    n_layers = b_l.shape[0]
    ws = unpack(wpk_l[None], n_layers)
    xs = [buf[..., :RDN_G0 * (i + 1)].contiguous() for i in range(n_layers)]
    wf = wf_l.reshape(1, 1, *wf_l.shape)
    fwd = [lib_conv(x, w[0], b) for x, w, b in zip(xs, ws, b_l)]
    fwd.append(lib_conv(buf, wf, bf_l))
    bwd = [lib_conv_bwd(x, w[0], g) for x, w in zip(xs, ws)]
    bwd.append(lib_conv_bwd(buf, wf, g))
    dw = [lib_wgrad(x[None], g[None]) for x in xs]
    return fwd, bwd, dw


def _rdn_times(tag: str, fns: dict, smi: str) -> dict:
    """Each K6 function's (and its reference's) device time alone (CUDA
    graph), CUDA-event time of back-to-back calls and host time a call;
    printed and returned by name."""
    out = {}
    for name, fn in fns.items():
        out[name] = (graph_ms(fn, 5, 3), median_ms(fn, 5, 3), host_ms(fn))
        print(f'K6 {tag} {name}: device {out[name][0]:.4f} ms, CUDA events '
              f'{out[name][1]:.4f} ms, host {out[name][2]:.4f} ms a call  '
              f'[{smi}]', flush=True)
    return out


def check_rdn_kernels(device, smi: str) -> dict:
    """Phase 2e. K6's forward (saving), one block's chain and its pair
    weight grads against the plain versions at the training, predict and
    ragged shapes; two calls bit-identical. Returns K6 / K6b / K6w stats,
    timed at the training shape (the forward per call of all 16 blocks,
    the chain and the weight grads per block), with their device times
    alone and cuDNN's for the same work (:func:`rdn_reference`; at the
    predict shape too, printed)."""
    stats = new_stats(('K6', 'K6b', 'K6w'))
    c_tot = RDN_G0 * (RDN_C + 1)
    for i, (bsz, h, w) in enumerate(K6_SHAPES):
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
        if i < 2:
            fwd_ref, bwd_ref, dw_ref = rdn_reference(
                bufs[l], args[1][l], args[2][l], args[3][l], args[4][l], g)
            dev = _rdn_times(tag, {
                'fwd (16 blocks, saving)': lambda: rdn_fwd(*args, save=True),
                'chain (one block)': lambda: rdb_bwd_chain(*bargs),
                'pair weight grads (one block)':
                    lambda: rdb_bwd_dw(bufs, l, bref[1]),
                'cuDNN reference fwd (16 x 8 convs + 1x1)':
                    lambda: [f() for _ in range(RDN_D) for f in fwd_ref],
                'cuDNN reference bwd (one block: 8 convs + 1x1)':
                    lambda: [f() for f in bwd_ref],
                'cuDNN reference dW (one block: 8 conv2d_weight)':
                    lambda: [f() for f in dw_ref]}, smi)
            del fwd_ref, bwd_ref, dw_ref
        cms = median_ms(lambda: rdb_bwd_chain(*bargs), 5, 3)
        if i == 0:
            _profile(lambda: rdb_bwd_chain(*bargs), cms, smi, (),
                     f'K6 chain {tag} (one block)', top=12)
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
            times = list(dev.values())
            for kid, (d_ms, _, h_ms), ref in zip(
                    ('K6', 'K6b', 'K6w'), times[:3],
                    (times[3], times[4], times[5])):
                stats[kid].update(device_ms=d_ms, host_ms=h_ms,
                                  reference_ms=ref[1],
                                  reference_device_ms=ref[0])
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
                ('bwd', lambda: conv3x3_bwd(x, wt, g)),
                ('bwd_plain', lambda: conv3x3_bwd_plain(x, wt, g)),
                ('w', lambda: conv_wgrad(x, g, k=k)),
                ('w_plain', lambda: conv_wgrad_plain(x, g, k=k)))}
            t.update((name, lib_ms(fn)) for name, fn in (
                ('fwd_lib', lib_conv(x, wt, b)),
                ('bwd_lib', lib_conv_bwd(x, wt, g)),
                ('w_lib', lib_wgrad(x[None], g[None], k))))
            f_fl = conv_flops(px, cin, cout, k)
            print(f'K2 general {tag}: fwd kernel {t["fwd"]:.4f} ms plain '
                  f'{t["fwd_plain"]:.4f} lib {t["fwd_lib"][0]:.4f} / '
                  f'benchmark {t["fwd_lib"][1]:.4f} (bound '
                  f'{max(bound(f_fl, nbytes(x, wt, b, got))):.5f}); bwd '
                  f'kernel {t["bwd"]:.4f} plain {t["bwd_plain"]:.4f} lib '
                  f'{t["bwd_lib"][0]:.4f} / {t["bwd_lib"][1]:.4f} (bound '
                  f'{max(bound(2 * f_fl, nbytes(x, wt, g, bgot))):.5f}); '
                  f'weight grads kernel {t["w"]:.4f} plain '
                  f'{t["w_plain"]:.4f} lib {t["w_lib"][0]:.4f} / '
                  f'{t["w_lib"][1]:.4f} (bound '
                  f'{max(bound(f_fl, nbytes(x, g, bgot[1:]))):.5f})  [{smi}]')
            if (cin, cout, k) in K2G_X4 and i == 1:
                add_lib(stats['K2g'], t['fwd_lib'])
                record(stats['K2g'], t['fwd'], t['fwd_plain'], f_fl,
                       nbytes(x, wt, b, got))
            if (cin, cout, k) in K2G_X4 and i == 0:
                for key, pre, fl, moved in (
                        ('K2gb', 'bwd', 2 * f_fl, nbytes(x, wt, g, bgot)),
                        ('Wg', 'w', f_fl, nbytes(x, g, bgot[1:]))):
                    add_lib(stats[key], t[pre + '_lib'])
                    record(stats[key], t[pre], t[pre + '_plain'], fl, moved)
                bwd_split(stats['K2gb'], x, wt, g, smi, f'K2gb {tag}')
            if k == 5 and i == 1:
                add_lib(stats['K2g5'], t['fwd_lib'])
                record(stats['K2g5'], t['fwd'], t['fwd_plain'], f_fl,
                       nbytes(x, wt, b, got))
            if k == 5 and i == 0:
                add_lib(stats['K2g5b'], t['bwd_lib'])
                record(stats['K2g5b'], t['bwd'], t['bwd_plain'], 2 * f_fl,
                       nbytes(x, wt, g, bgot))
                bwd_split(stats['K2g5b'], x, wt, g, smi, f'K2g5b {tag}')
        torch.cuda.empty_cache()
    return stats


# Phase 2l: the weight-grad engine (W, csrc/wgrad.cu) at every class the
# main paths launch (tests/test_torch_wgrad_shapes.py holds the models'
# classes to this list): (label, k, c_in, c_out, r, reflect, gscale, jobs,
# LR multiple). Each at the training shape (batch 16, LR 32x32 times the
# multiple) and at 2 x 67 x 45 (times the multiple), against
# conv_wgrad_plain within 1e-4 of the largest magnitude (f32 sums of the
# same bf16 products in another order), two calls bit-identical; at the
# training shape its time, its bound and torch.nn.grad.conv2d_weight's
# with cuDNN's heuristics and in benchmark mode (one call computes the
# same function where there is no gather and no reflect). The device's
# time alone, without the wrapper's host time: tools/wgrad_plans.py.
W_CASES = (
    ('EDSR / RCAN trunk, 16 stacked jobs', 3, C, C, 1, False, 1.0, L, 1),
    ('trunk dW2 at res_scale 0.1, 16 stacked jobs', 3, C, C, 1, False, 0.1,
     L, 1),
    ('EDSR 64 x 86 trunk dW2, 86 stacked jobs, res_scale 0.1', 3, C, C, 1,
     False, EDSR86_RS, EDSR86_L, 1),
    ('close 64->64 (K2b, K4 BN block)', 3, C, C, 1, False, 1.0, 1, 1),
    ('K3 r=2 gather 64->256', 3, C, 4 * C, 2, False, 1.0, 1, 1),
    ('phase-major 64->256 at 2x', 3, C, 4 * C, 1, False, 1.0, 1, 2),
    ('phase-dense 256->16 at 2x', 3, 4 * C, 16, 1, False, 1.0, 1, 2),
    ('phase-dense 5x5 256->16 at 2x', 5, 4 * C, 16, 1, False, 1.0, 1, 2),
    ('K4r reflect 64->64 (SRGAN)', 3, C, C, 1, True, 1.0, 1, 1),
    # K4's trunk op: every conv's weight grads of a trunk in one launch
    ('K4 BN trunk 64->64, 33 stacked jobs', 3, C, C, 1, False, 1.0,
     2 * L + 1, 1),
    ('K4r BN trunk reflect 64->64, 33 stacked jobs', 3, C, C, 1, True, 1.0,
     2 * L + 1, 1),
    *((f'DDBPN x4 {ci}->{co}', k, ci, co, 1, False, 1.0, 1, 1)
      for ci, co, k in K2G_X4),
    ('x3 phase-major 64->576', 3, C, 9 * C, 1, False, 1.0, 1, 1),
    ('x3 phase-dense 576->32', 3, 9 * C, 32, 1, False, 1.0, 1, 1),
    ('x3 phase-dense 5x5 576->32', 5, 9 * C, 32, 1, False, 1.0, 1, 1),
    *((f'K9c dense layer {C * i}->{C}', 3, C * i, C, 1, False, 1.0, 1, 1)
      for i in range(1, 9)),
    # K6's pair weight grads' split (rdb_bwd_dw: 36 jobs of 64 -> 64 in
    # one launch, its pairs mode), here on stacked copies
    ('K6 pairs 64->64, 36 stacked jobs', 3, C, C, 1, False, 1.0, 36, 1),
    ('K7 dW3 128->128', 3, WDSR_C, WDSR_C, 1, False, 1.0, 1, 1),
    ('K9d [hi | lo] 64->128', 3, C, 2 * C, 1, False, 1.0, 1, 1),
)


def w_cases(device, bsz: int, h: int, w: int) -> list[tuple]:
    """(label, k, c_in, c_out, r, reflect, gscale, jobs, x, g) of each W
    case for a batch of h x w LR patches."""
    gen = torch.Generator().manual_seed(bsz * 1000 + h * 10 + w)
    out = []
    for label, k, cin, cout, r, rf, gs, jobs, mult in W_CASES:
        hh, ww = h * mult, w * mult
        lead = (jobs,) if jobs > 1 else ()
        gshape = ((*lead, bsz, r * hh, r * ww, cout // (r * r)) if r > 1
                  else (*lead, bsz, hh, ww, cout))
        x = _uniform(gen, (*lead, bsz, hh, ww, cin), 1.0, device,
                     torch.bfloat16)
        g = _uniform(gen, gshape, 1.0, device, torch.bfloat16)
        out.append((label, k, cin, cout, r, rf, gs, jobs, x, g))
    return out


def check_w_classes(device, smi: str) -> tuple[list, float]:
    """Phase 2l. Returns the W row's classes (each at the training shape:
    ms, bound, bound_by, library ms in both modes) and the largest dW
    error over all cases."""
    classes, worst = [], 0.0
    for i, (bsz, h, w) in enumerate(((TRAIN_BATCH, TRAIN_PATCH // SCALE,
                                      TRAIN_PATCH // SCALE), (2, 67, 45))):
        for label, k, cin, cout, r, rf, gs, jobs, x, g in w_cases(
                device, bsz, h, w):
            run = lambda: conv_wgrad(x, g, gs, r, k, rf)
            got = run()
            torch.cuda.synchronize()
            ref = conv_wgrad_plain(x, g, gs, r, k, rf)
            tag = f'{label} {bsz}x{x.shape[-3]}x{x.shape[-2]}'
            need(all(torch.equal(a, b) for a, b in zip(got, run())),
                 f'W {tag}: two calls differ')
            errs = [_err(a, b, None) for a, b in zip(got, ref)]
            for e, t, _ in errs:
                need(np.isfinite(e) and e <= t, f'W {tag}: {e} > {t}')
            worst = max(worst, errs[0][0])
            line = (f'W {tag}: dW max_abs {errs[0][0]:.4g} tol '
                    f'{errs[0][1]:.4g}, db {errs[1][0]:.4g} tol '
                    f'{errs[1][1]:.4g}; deterministic')
            if i == 0:
                ms = median_ms(run)
                ops_ms, bytes_ms = bound(
                    conv_flops(x.numel() // cin, cin, cout, k),
                    nbytes(x, g, got))
                lib = (None, None)
                if r == 1 and not rf:
                    lead = (lambda t: t) if jobs > 1 else (lambda t: t[None])
                    lib = lib_ms(lib_wgrad(lead(x), lead(g), k))
                classes.append({
                    'case': label, 'ms': ms,
                    'bound_ms': max(ops_ms, bytes_ms),
                    'bound_by': 'operations' if ops_ms >= bytes_ms
                    else 'bytes',
                    'library_ms': lib[0], 'library_bench_ms': lib[1],
                    'max_abs_err': errs[0][0]})
                line += (f' | kernel {ms:.4f} ms, bound '
                         f'{max(ops_ms, bytes_ms):.5f} '
                         f'({classes[-1]["bound_by"]}), conv2d_weight '
                         + ('none' if lib[0] is None else
                            f'{lib[0]:.4f} / benchmark {lib[1]:.4f}'))
            print(f'{line}  [{smi}]')
            del got, ref, x, g
        torch.cuda.empty_cache()
    return classes, worst


# Phase 2k: K2's forward at the training shape (batch 16, LR 32x32): (k,
# c_in, c_out, LR multiple) of the EDSR x4 tail (the close conv, which
# RCAN's and RDN's share, at LR; the phase-major and phase-dense convs at
# 2x), SRResNet's 5x5 phase-dense conv, DDBPN x4's three and the x3 tails
# (EDSR's phase-major 64 -> 576 and 3x3 576 -> 32, SRResNet's 5x5 576 ->
# 32, all at LR)
K2_TRAIN_FWD = {'K2t': ((3, C, C, 1), (3, C, 4 * C, 2), (3, 4 * C, 16, 2)),
                'K25t': ((5, 4 * C, 16, 2),),
                'K2gt': tuple((k, ci, co, 1) for ci, co, k in K2G_X4),
                'K2x3t': ((3, C, 9 * C, 1), (3, 9 * C, 32, 1),
                          (5, 9 * C, 32, 1))}


def check_k2_train_fwd(device, smi: str) -> dict:
    """Phase 2k. K2's forward at the training shape at every shape of
    K2_TRAIN_FWD against its plain version (one step), two calls
    bit-identical; kernel, plain, bound and library times (cuDNN's
    heuristic and benchmark mode), summed per row."""
    stats = new_stats(K2_TRAIN_FWD)
    bsz, lr = TRAIN_BATCH, TRAIN_PATCH // SCALE
    for kid, shapes in K2_TRAIN_FWD.items():
        st = stats[kid]
        for k, cin, cout, m in shapes:
            h = lr * m
            gen = torch.Generator().manual_seed(k * 100003 + cin * 101 + cout)
            x = _uniform(gen, (bsz, h, h, cin), 1.0, device, torch.bfloat16)
            wt = _uniform(gen, (k, k, cin, cout), (k * k * cin) ** -0.5,
                          device, torch.bfloat16)
            b = _uniform(gen, (cout,), 0.1, device, torch.float32)
            tag = f'{kid} {k}x{k} {cin}->{cout} {bsz}x{h}x{h}'
            got = conv3x3_fwd(x, wt, b)
            torch.cuda.synchronize()
            need(torch.equal(got, conv3x3_fwd(x, wt, b)),
                 f'{tag}: two calls differ')
            err = _check_all(tag, ('y',), [got], [conv3x3_plain(x, wt, b)],
                             [TOL_STEPS['K2']])
            st['max_abs_err'] = max(st['max_abs_err'], err)
            flops, moved = conv_flops(bsz * h * h, cin, cout, k), nbytes(
                x, wt, b, got)
            ms = median_ms(lambda: conv3x3_fwd(x, wt, b))
            pms = median_ms(lambda: conv3x3_plain(x, wt, b), 5, 3)
            lib = lib_ms(lib_conv(x, wt, b))
            print(f'{tag}: kernel {ms:.4f} ms plain {pms:.4f} bound '
                  f'{max(bound(flops, moved)):.5f} library {lib[0]:.4f} / '
                  f'benchmark {lib[1]:.4f}  [{smi}]')
            record(st, ms, pms, flops, moved)
            add_lib(st, lib)
        print(f'{kid} forward at the training shape, summed: kernel '
              f'{st["ms"]:.4f} ms plain {st["plain_ms"]:.4f} bound '
              f'{st["bound_ms"]:.5f} library {st["library_ms"]:.4f} / '
              f'benchmark {st["library_bench_ms"]:.4f}  [{smi}]')
    return stats


def wdsr_case(gen, device, bsz: int, h: int, w: int, lp: int = WDSR_LP,
              n: int | None = None) -> tuple:
    """K7's operands at WDSR-B's width (C 128, e 768, L 102 padded to Lp
    ``lp`` with zero rows: srtpu's 112, or the kernels' 128) at srtpu's
    init bounds, stacked ``n`` deep when given, and a cotangent g."""
    bf, f32 = torch.bfloat16, torch.float32
    c, e, lv = WDSR_C, WDSR_E, WDSR_LV
    lead = () if n is None else (n,)

    def u(shape, bound, dt=bf):
        return _uniform(gen, (*lead, *shape), bound, device, dt)

    def padded(t, dim):
        dim += len(lead)
        return F.pad(t, (0, 0) * (t.dim() - 1 - dim) + (0, lp - lv))
    return (_uniform(gen, (bsz, h, w, c), 1.0, device, bf),
            u((c, e), c ** -0.5), u((e,), c ** -0.5, f32),
            padded(u((e, lv), e ** -0.5), 1),
            padded(u((lv,), e ** -0.5, f32), 0),
            padded(u((3, 3, lv, c), (9 * lv) ** -0.5), 2).contiguous(),
            u((c,), (9 * lv) ** -0.5, f32),
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


def _k7_trunk(device, smi: str, stats: dict, bsz: int, h: int, w: int,
              timed: bool, rs: float = 1.0) -> None:
    """K7's trunk of WDSR_L blocks, one host call each way, at the
    kernels' Lp, against the plain versions block after block (the
    backward's from the kernel's saved block inputs): out, the saved
    inputs, dx and the stacked grads within K7T_STEPS / K7TB_STEPS; the
    forward without saving bit-identical to the saving one's out; two
    calls bit-identical; timed (device and host) where ``timed``."""
    gen = torch.Generator().manual_seed(bsz * 7937 + h * 131 + w)
    x, *sp, g = wdsr_case(gen, device, bsz, h, w, k7ops.kernel_lp(WDSR_C),
                          WDSR_L)
    tag = f'K7 trunk L={WDSR_L} res_scale {rs} {bsz}x{h}x{w}'
    fargs = (x, *sp, rs)
    got = k7ops.wdsr_trunk_fwd(*fargs, save=True)
    torch.cuda.synchronize()
    _same_twice(lambda: k7ops.wdsr_trunk_fwd(*fargs, save=True), got,
                f'{tag} fwd')
    need(torch.equal(k7ops.wdsr_trunk_fwd(*fargs), got[0]),
         f'{tag}: the forward without saving differs from the saving one')
    ref = k7ops.wdsr_trunk_plain(*fargs, save=True)
    err = _check_all(f'{tag} fwd (saving)', K7T_STEPS, got[:2], ref[:2],
                     list(K7T_STEPS.values()))
    stats['K7']['max_abs_err'] = max(stats['K7']['max_abs_err'], err)
    bargs = (got[1], got[2], g, *sp[:5], rs)
    bgot = k7ops.wdsr_trunk_bwd(*bargs)
    torch.cuda.synchronize()
    _same_twice(lambda: k7ops.wdsr_trunk_bwd(*bargs), bgot, f'{tag} bwd')
    bref = k7ops.wdsr_trunk_bwd_plain(got[1], g, *sp[:5], rs)
    err = _check_all(f'{tag} bwd', K7TB_STEPS, bgot, bref,
                     list(K7TB_STEPS.values()))
    stats['K7b']['max_abs_err'] = max(stats['K7b']['max_abs_err'], err)
    if not timed:
        return
    times = {}
    for kid, fn in (('K7', lambda: k7ops.wdsr_trunk_fwd(*fargs)),
                    ('K7b', lambda: k7ops.wdsr_trunk_bwd(*bargs))):
        times[kid] = (graph_ms(fn, 3, 3), host_ms(fn))
    print(f'{tag}, one host call each way: fwd device {times["K7"][0]:.4f} '
          f'ms ({times["K7"][0] / WDSR_L:.5f} a block), host '
          f'{times["K7"][1]:.4f} ms; bwd device {times["K7b"][0]:.4f} ms '
          f'({times["K7b"][0] / WDSR_L:.5f} a block), host '
          f'{times["K7b"][1]:.4f} ms  [{smi}]')
    if bsz == TRAIN_BATCH:
        for kid, (dev, host) in times.items():
            stats[kid]['trunk_device_ms'] = dev
            stats[kid]['trunk_host_ms'] = host


def check_wdsr_kernels(device, smi: str) -> dict:
    """Phase 2g. K7's forward and backward against the plain versions at
    the training shape (batch 16, LR 32x32), the predict shape (batch 1,
    128x128) and a ragged batch 2 of 67x45, C = 128, res_scale 1 (srtpu's
    default): one block at srtpu's Lp 112 (the wrappers pad to the
    kernels' 128; its backward from the block input and h2 that its
    saving forward kept, as WDSR-B runs it) and the 16-block trunk in
    one host call each way (:func:`_k7_trunk`; at the ragged shape at
    res_scale 0.1 too); every output beside its tolerance, two calls
    bit-identical, kernel, plain and bound times (and the device's
    alone, a CUDA graph of the calls), and one stock-route block (cuDNN)
    timed beside each way, on the device too. Returns K7 / K7b stats,
    timed at the training shape (per block)."""
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
        # the backward as WDSR-B runs it: a trunk of one, from the block
        # input and h2 its forward saved
        one = [t[None] for t in prm]
        _, xs1, h2s1 = k7ops.wdsr_trunk_fwd(x, *one, 1.0, save=True)

        def kbwd():
            out = k7ops.wdsr_trunk_bwd(xs1, h2s1, g, *one[:5], 1.0)
            return (out[0], *(t[0] for t in out[1:]))
        bgot = kbwd()
        torch.cuda.synchronize()
        bref = wdsr_bwd_plain(*bargs)
        need(all(torch.equal(a, b) for a, b in zip(bgot, kbwd())),
             f'K7 bwd {tag}: two calls differ')
        err = _check_all(f'K7 wdsr bwd {tag}', K7B_STEPS, bgot, bref,
                         list(K7B_STEPS.values()))
        stats['K7b']['max_abs_err'] = max(stats['K7b']['max_abs_err'], err)
        _k7_trunk(device, smi, stats, bsz, h, w, i != 2)
        if i == 2:
            _k7_trunk(device, smi, stats, bsz, h, w, False, K7_SCALES[1])
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
        bms = median_ms(kbwd, 10, 3)
        bpl = median_ms(lambda: wdsr_bwd_plain(*bargs), 3, 3)
        # the device's time alone (a CUDA graph of the calls)
        fdev = graph_ms(lambda: wdsr_fwd(*fargs), 10, 3)
        bdev = graph_ms(kbwd, 10, 3)
        f_moved = nbytes(fun, got)
        b_moved = nbytes(g, fun[:6], bgot[:3], bgot[3][:, :lv],
                         bgot[4][:lv], bgot[5][:, :, :lv], bgot[6])
        f_bound = max(bound(fwd_flops, f_moved))
        b_bound = max(bound(2 * fwd_flops, b_moved))
        # the stock route's block, forward and forward + backward, with
        # cuDNN's benchmark mode on (its fastest algorithms), back to
        # back and on the device alone
        sw = stock_operands(*fun)
        gc = g.permute(0, 3, 1, 2)
        bench_mode = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True

        def stock_fwd():
            with torch.no_grad():
                return stock_block(*sw)

        def stock_both():
            return torch.autograd.grad(stock_block(*sw), sw, gc)
        sms, sdev = median_ms(stock_fwd, 10, 3), graph_ms(stock_fwd, 10, 3)
        sbms, sbdev = (median_ms(stock_both, 10, 3),
                       graph_ms(stock_both, 10, 3))
        torch.backends.cudnn.benchmark = bench_mode
        print(f'K7 {tag}: fwd kernel {fms:.4f} ms (device {fdev:.4f}) plain '
              f'{fpl:.4f} ms bound {f_bound:.5f} ms; bwd (incl. dW3 / db3) '
              f'kernel {bms:.4f} ms (device {bdev:.4f}) plain {bpl:.4f} ms '
              f'bound {b_bound:.5f} ms  [{smi}]')
        print(f'K7 {tag}: stock route, one block on cuDNN (1x1, ReLU, 1x1, '
              f'3x3, x res_scale + x; bf16, activations and weights '
              f'channels-last, benchmark mode): fwd {sms:.4f} ms (device '
              f'{sdev:.4f}), fwd + bwd {sbms:.4f} ms (device {sbdev:.4f}) '
              f'(a reference, not library_ms: no single PyTorch call '
              f'computes the block)  [{smi}]')
        if i == 0:
            record(stats['K7'], fms, fpl, fwd_flops, f_moved)
            record(stats['K7b'], bms, bpl, 2 * fwd_flops, b_moved)
            stats['K7']['device_ms'] = fdev
            stats['K7b']['device_ms'] = bdev
            stats['K7']['reference_ms'] = sms
            stats['K7']['reference_device_ms'] = sdev
            stats['K7b']['reference_ms'] = sbms
            stats['K7b']['reference_device_ms'] = sbdev
        del got, ref, bgot, bref, sw, xs1, h2s1
        torch.cuda.empty_cache()
    return stats


def k8_cases(gen, device, bsz: int, h: int, w: int) -> dict:
    """Each K8 function's (wrapper, plain, args, kwargs, matrix FLOPs) at
    an h x w batch, srtpu's init bounds: K8a at 64 channels (res_scale 1,
    h1 saved, as training runs it), K8b at 64 channels, reduction 16
    (f32 weights), K8c at WDSR-B's 128 (e 768, L 102, unpadded: the
    wrapper pads)."""
    bf, f32 = torch.bfloat16, torch.float32
    px = bsz * h * w
    cb = (9 * C) ** -0.5
    a = (_uniform(gen, (bsz, h, w, C), 1.0, device, bf),
         _uniform(gen, (3, 3, C, C), cb, device, bf),
         _uniform(gen, (C,), cb, device, f32),
         _uniform(gen, (3, 3, C, C), cb, device, bf),
         _uniform(gen, (C,), cb, device, f32), 1.0)
    b = (_uniform(gen, (bsz, h, w, C), 1.0, device, bf),
         _uniform(gen, (C, CR), C ** -0.5, device, f32),
         _uniform(gen, (CR,), C ** -0.5, device, f32),
         _uniform(gen, (CR, C), CR ** -0.5, device, f32),
         _uniform(gen, (C,), CR ** -0.5, device, f32))
    c, e, lv = WDSR_C, WDSR_E, WDSR_LV
    cc = (_uniform(gen, (bsz, h, w, c), 1.0, device, bf),
          _uniform(gen, (c, e), c ** -0.5, device, bf),
          _uniform(gen, (e,), c ** -0.5, device, f32),
          _uniform(gen, (e, lv), e ** -0.5, device, bf),
          _uniform(gen, (lv,), e ** -0.5, device, f32),
          _uniform(gen, (3, 3, lv, c), (9 * lv) ** -0.5, device, bf),
          _uniform(gen, (c,), (9 * lv) ** -0.5, device, f32), 1.0)
    return {
        'K8a': (resblock_fused_fwd, resblock_fused_plain, a,
                {'save_h1': True}, 2 * conv_flops(px, C, C)),
        'K8b': (ca_layer_fwd, ca_layer_plain, b, {}, 0.0),
        'K8c': (wdsr_block_fused_fwd, wdsr_block_fused_plain, cc, {},
                2.0 * px * (e * c + lv * e + 9 * c * lv))}


def _k8c_blocks(device, smi: str, stats: dict, bsz: int, h: int,
                w: int) -> None:
    """K8c over WDSR_L blocks, one call a block as the True route runs
    it: the device's time (a CUDA graph) and the host's."""
    gen = torch.Generator().manual_seed(bsz * 7949 + h * 137 + w)
    x, *sp, _ = wdsr_case(gen, device, bsz, h, w, WDSR_LV, WDSR_L)

    def blocks():
        y = x
        for i in range(WDSR_L):
            y = wdsr_block_fused_fwd(y, *(t[i] for t in sp), 1.0)
        return y
    dev, host = graph_ms(blocks, 3, 3), host_ms(blocks)
    print(f'K8c over {WDSR_L} blocks {bsz}x{h}x{w}: device {dev:.4f} ms '
          f'({dev / WDSR_L:.5f} a block), host {host:.4f} ms  [{smi}]')
    if bsz == TRAIN_BATCH:
        stats['K8c']['trunk_device_ms'] = dev
        stats['K8c']['trunk_host_ms'] = host


def _k8a_trunk(device, smi: str, stats: dict, bsz: int, h: int,
               w: int) -> None:
    """K8a's trunk op over L blocks at one shape (srtpu's init bounds, f32
    parameters as EDSR holds them, res_scale 1): the forward call saving
    and not against the per-block plain route (out, xs, h1s within
    TOL_STEPS['K1'], as K1's 16-block trunk), two calls bit-identical,
    the output equal to L per-block kernel calls; at the training shape,
    through autograd each way the per-block kernel route's bits (``resblock_fused`` a block,
    cuDNN's deterministic algorithms for the stock backward), and
    against the per-block plain route out within TOL_STEPS['K1']. The
    backward is stock on every path, fed each path's saved bf16
    activations: where a block's input sits a step apart, a ReLU mask
    (h1 > 0) flips at pixels whose pre-activation is that near 0 and
    moves dh1 there by its whole value, so the gradients against the
    plain route are printed, and held at the model's level by phase 19
    (STEP_GRAD_TOL on the parameters' gradients). Unragged shapes: the trunk's device and host
    time beside cuDNN's calls for its work (:func:`trunk_reference`); at
    the training shape also one block's (the K8a row's device_ms,
    host_ms, reference_ms, reference_device_ms; trunk_device_ms,
    trunk_host_ms, trunk_reference_device_ms)."""
    gen = torch.Generator().manual_seed(bsz * 7937 + h * 131 + w)
    cb = (9 * C) ** -0.5
    bf, f32 = torch.bfloat16, torch.float32
    x = _uniform(gen, (bsz, h, w, C), 1.0, device, bf)
    prm = [_uniform(gen, shape, cb, device, f32)
           for shape in ((L, 3, 3, C, C), (L, C), (L, 3, 3, C, C), (L, C))]
    ops = k8a_ops._cast(x, *prm)
    tag = f'K8a trunk op L={L} {bsz}x{h}x{w}x{C}'
    for save in (False, True):
        got = _as_list(resblock_trunk_fwd(x, *ops, 1.0, save=save))
        torch.cuda.synchronize()
        _same_twice(lambda: resblock_trunk_fwd(x, *ops, 1.0, save=save),
                    got, f'{tag} save={save}')
        ref = _as_list(resblock_trunk_plain(x, *ops, 1.0, save=save))
        _check_all(f'{tag} fwd, saving {save}', ('out', 'xs', 'h1s'), got,
                   ref, [TOL_STEPS['K1']] * 3)
        if not save:
            y = x
            for i in range(L):
                y = resblock_fused_fwd(y, *(t[i] for t in ops), 1.0)
            need(torch.equal(y, got[0]), f'{tag}: not its blocks\' bits')
        del got, ref
    if bsz == TRAIN_BATCH:     # each way at the shape training runs
        _k8a_trunk_grads(x, prm, tag, smi)
    if (bsz, h, w) != (2, 67, 45):
        _k8a_trunk_times(x, ops, smi, stats, bsz, h, w)


def _k8a_trunk_grads(x, prm, tag: str, smi: str) -> None:
    """:func:`_k8a_trunk` through autograd, each way."""
    res = {}
    for route in ('trunk', 'blocks', 'plain'):
        xx = x.clone().requires_grad_()
        pp = [t.clone().requires_grad_() for t in prm]
        with _cudnn_deterministic():    # the stock backward's cuDNN convs
            if route == 'trunk':
                out = resblock_fused_trunk(xx, *pp, 1.0)
            else:
                out = xx
                for i in range(L):
                    out = resblock_fused(out, *(t[i] for t in pp), 1.0,
                                         route == 'plain')
            out.float().square().mean().backward()
        res[route] = [out.detach(), xx.grad, *(t.grad for t in pp)]
    names = ('out', 'dx', 'dW1', 'db1', 'dW2', 'db2')
    differ = [n for n, a, b in zip(names, res['trunk'], res['blocks'])
              if not torch.equal(a, b)]
    need(not differ, f'{tag}: through autograd, {differ} not its blocks\' '
         f'bits')
    _check_all(f'{tag} through autograd, out', ('out',), res['trunk'][:1],
               res['plain'][:1], [TOL_STEPS['K1']])
    rel = ', '.join(
        f'{name} {(gk - gp).abs().max().item() / gp.abs().max().item():.4g}'
        for name, gk, gp in zip(names[1:], res['trunk'][1:],
                                res['plain'][1:]))
    print(f'{tag} each way: output and gradients the per-block kernel '
          f'route\'s bits; against the per-block plain route (a stock '
          f'backward on each path\'s saved activations) max_abs/max|ref| '
          f'{rel}  [{smi}]')


def _k8a_trunk_times(x, ops, smi: str, stats: dict, bsz: int, h: int,
                     w: int) -> None:
    """:func:`_k8a_trunk`'s times."""
    ref_fwd = trunk_reference(x, *ops, 1.0, x.expand((L, *x.shape)), x)[0]
    one = [t[:1] for t in ops]
    ref_one = trunk_reference(x, *one, 1.0, x[None], x)[0]
    fns = {'trunk fwd (predict)': lambda: resblock_trunk_fwd(x, *ops, 1.0),
           'trunk fwd (saving)':
               lambda: resblock_trunk_fwd(x, *ops, 1.0, save=True),
           'cuDNN reference, 16 blocks (2 F.conv2d, ReLU, scaled skip '
           'a block)': ref_fwd,
           'one block (saving h1)': lambda: resblock_fused_fwd(
               x, *(t[0] for t in ops), 1.0, save_h1=True),
           'cuDNN reference, one block': ref_one}
    times = {}
    for name, fn in fns.items():
        times[name] = (graph_ms(fn, 5 if 'one' not in name else 20, 3),
                       median_ms(fn, 5, 3), host_ms(fn))
        d, e, hh = times[name]
        print(f'K8a {name} {bsz}x{h}x{w}: device {d:.4f} ms, CUDA events '
              f'{e:.4f} ms, host {hh:.4f} ms a call  [{smi}]', flush=True)
    if bsz == TRAIN_BATCH:
        one_ref = times['cuDNN reference, one block']
        stats['K8a'].update(
            device_ms=times['one block (saving h1)'][0],
            host_ms=times['one block (saving h1)'][2],
            reference_ms=one_ref[1], reference_device_ms=one_ref[0],
            trunk_device_ms=times['trunk fwd (saving)'][0],
            trunk_host_ms=times['trunk fwd (saving)'][2],
            trunk_reference_device_ms=times[
                'cuDNN reference, 16 blocks (2 F.conv2d, ReLU, scaled skip '
                'a block)'][0])


def check_k8_kernels(device, smi: str) -> dict:
    """Phase 2i. K8a (out and h1), K8b and K8c against their plain versions
    at the training shape (batch 16, LR 32x32), the predict shape (batch
    1, 128x128) and a ragged batch 2 of 67x45: every output within one
    bf16 step of its largest magnitude, two calls bit-identical; kernel,
    plain and bound times (no library call computes any of the three);
    K8c over 16 blocks timed at the two unragged shapes
    (:func:`_k8c_blocks`). Returns K8a / K8b / K8c stats, timed at the
    training shape."""
    stats = new_stats(('K8a', 'K8b', 'K8c'))
    shapes = ((TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE),
              (1, 128, 128), (2, 67, 45))
    for i, (bsz, h, w) in enumerate(shapes):
        gen = torch.Generator().manual_seed(bsz * 7919 + h * 127 + w)
        for kid, (fn, plain, args, kw, flops) in k8_cases(
                gen, device, bsz, h, w).items():
            got = _as_list(fn(*args, **kw))
            torch.cuda.synchronize()
            ref = _as_list(plain(*args, **kw))
            tag = f'{kid} {bsz}x{h}x{w}x{args[0].shape[-1]}'
            need(all(torch.equal(a, b) for a, b in
                     zip(got, _as_list(fn(*args, **kw)))),
                 f'{tag}: two calls differ')
            names = ('out', 'h1')[:len(got)]
            err = _check_all(tag, names, got, ref, [K8_STEPS] * len(got))
            stats[kid]['max_abs_err'] = max(stats[kid]['max_abs_err'], err)
            if i == 2:
                continue
            ms = median_ms(lambda: fn(*args, **kw))
            plain_ms = median_ms(lambda: plain(*args, **kw), 5, 3)
            moved = nbytes(args, got)
            print(f'{tag}: kernel {ms:.4f} ms plain {plain_ms:.4f} ms '
                  f'bound {max(bound(flops, moved)):.5f} ms ({flops / 1e9:.3f}'
                  f' GFLOP, {moved / 1e6:.3f} MB)  [{smi}]')
            if i == 0:
                record(stats[kid], ms, plain_ms, flops, moved)
            if kid == 'K8b':
                _k8b_times(stats[kid], fn, args, i == 0, smi, tag)
            del got, ref
        if i != 2:
            _k8c_blocks(device, smi, stats, bsz, h, w)
        _k8a_trunk(device, smi, stats, bsz, h, w)
        torch.cuda.empty_cache()
    for bsz, h, w in K8B_SHAPES:
        gen = torch.Generator().manual_seed(bsz * 7919 + h * 127 + w)
        fn, plain, args, _, _ = k8_cases(gen, device, bsz, h, w)['K8b']
        got = fn(*args)
        torch.cuda.synchronize()
        tag = f'K8b {bsz}x{h}x{w}x{C}'
        need(torch.equal(got, fn(*args)), f'{tag}: two calls differ')
        err = _check_all(tag, ('out',), [got], [plain(*args)], [K8_STEPS])
        stats['K8b']['max_abs_err'] = max(stats['K8b']['max_abs_err'], err)
        _k8b_times(stats['K8b'], fn, args, False, smi, tag)
        del got, args
        torch.cuda.empty_cache()
    return stats


def _k8b_times(st: dict, fn, args, keep: bool, smi: str, tag: str) -> None:
    """K8b's device time alone (a CUDA graph of its calls), host time a
    call and its pixels a block (ca_layer.block_pixels); ``keep``: into
    ``st`` as its device_ms and host_ms."""
    dev_ms, host = graph_ms(lambda: fn(*args)), host_ms(lambda: fn(*args))
    kpix = k8b_ops.block_pixels(*args[0].shape[1:3])
    print(f'{tag}: {kpix} pixels a block, device {dev_ms:.5f} ms '
          f'(a CUDA graph of its calls), host {host:.4f} ms a call  '
          f'[{smi}]', flush=True)
    if keep:
        st['device_ms'], st['host_ms'] = dev_ms, host


def _timed(st: dict, fn, plain, flops: float, moved: int, lib=None,
           launches: int = 5, plain_launches: int = 2) -> tuple:
    """Kernel and plain ms of one call (CUDA events, median of 3
    windows), recorded in ``st``; returns both."""
    ms = median_ms(fn, launches, 3)
    plain_ms = median_ms(plain, plain_launches, 3)
    record(st, ms, plain_ms, flops, moved, lib)
    return ms, plain_ms


def _print_times(tag: str, ms: float, plain_ms: float, flops: float,
                 moved: int, smi: str, extra: str = '') -> None:
    print(f'{tag}: kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound '
          f'{max(bound(flops, moved)):.5f} ms ({flops / 1e9:.3f} GFLOP, '
          f'{moved / 1e6:.3f} MB){extra}  [{smi}]')


def _same_twice(fn, got, what: str) -> None:
    need(all(torch.equal(a, b) for a, b in zip(_as_list(got),
                                               _as_list(fn()))),
         f'{what}: two calls differ')


def check_form_kernels(device, smi: str) -> dict:
    """Phase 2j. The counterparts of srtpu's other trunk forms and K8a's
    fused backward, each against its plain version at the shape its path
    gives it (the training shape, batch 16, LR 32x32), two calls
    bit-identical, with kernel, plain, bound and library times: K1 over
    86 blocks (srtpu's trunk_cs there; forward saving and backward) and
    at one block (resblock_cs), K6 at one RDN-B block (the calls trunk:
    forward, chain, pair weight grads), K9c (the 8 dense-layer convs of
    one block, forward and backward), K9d at res_scale 1.0 and 0.1 (the
    stock backward of EDSR's True route timed beside)."""
    ids = ('K1s', 'K1sb', 'K9a', 'K9ab', 'K9b', 'K9bc', 'K9bw', 'K9c',
           'K9cb', 'K9d')
    stats = new_stats(ids)
    bsz, h, w = TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE
    px = bsz * h * w
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator().manual_seed(2026)
    cb = (9 * C) ** -0.5

    # K1 over 86 blocks, res_scale 0.1
    nb, rs = EDSR86_L, EDSR86_RS
    args = (_uniform(gen, (bsz, h, w, C), 1.0, device, bf),
            _uniform(gen, (nb, 3, 3, C, C), cb, device, bf),
            _uniform(gen, (nb, C), cb, device, f32),
            _uniform(gen, (nb, 3, 3, C, C), cb, device, bf),
            _uniform(gen, (nb, C), cb, device, f32), rs)
    tag = f'K1s trunk_fwd L={nb} res_scale {rs} {bsz}x{h}x{w}'
    got = trunk_fwd(*args, save=True)
    torch.cuda.synchronize()
    ref = trunk_plain(*args, save=True)
    _same_twice(lambda: trunk_fwd(*args, save=True), got, tag)
    err = _check_all(f'{tag} fwd (saving)', ('out', 'xs', 'h1s'), got, ref,
                     [K1S_STEPS] * 3)
    exact = trunk_plain(*(a.float() if torch.is_tensor(a) else a
                          for a in args))
    e_k = (got[0].float() - exact).abs().max().item()
    e_p = (ref[0].float() - exact).abs().max().item()
    print(f'{tag} fwd vs the unrounded f32 trunk: kernel {e_k:.4g} plain '
          f'{e_p:.4g}')
    need(e_k <= 2 * e_p, f'{tag}: the kernel drifts from f32')
    del exact, ref
    stats['K1s']['max_abs_err'] = err
    flops, moved = 2 * nb * conv_flops(px, C, C), nbytes(args, got)
    ms, pms = _timed(stats['K1s'], lambda: trunk_fwd(*args, save=True),
                     lambda: trunk_plain(*args, save=True), flops, moved)
    _print_times(f'{tag} fwd', ms, pms, flops, moved, smi)
    g = _uniform(gen, (bsz, h, w, C), 1.0, device, bf)
    bargs = (got[1], got[2], g, args[1], args[3], rs)
    bgot = trunk_bwd(*bargs)
    torch.cuda.synchronize()
    bref = trunk_bwd_plain(*bargs)
    _same_twice(lambda: trunk_bwd(*bargs), bgot, f'{tag} bwd')
    err = _check_all(f'{tag} bwd', ('dx', 'dW1', 'db1', 'dW2', 'db2'), bgot,
                     bref, [K1S_STEPS] + [K1S_DW_STEPS] * 4)
    stats['K1sb']['max_abs_err'] = err
    flops, moved = 4 * nb * conv_flops(px, C, C), nbytes(bargs, bgot)
    ms, pms = _timed(stats['K1sb'], lambda: trunk_bwd(*bargs),
                     lambda: trunk_bwd_plain(*bargs), flops, moved, None, 3,
                     1)
    _print_times(f'{tag} bwd', ms, pms, flops, moved, smi)
    del got, bgot, bref, bargs
    torch.cuda.empty_cache()

    # K1 at one block (resblock_cs is the L = 1 trunk)
    one = (args[0], *(t[:1] for t in args[1:5]), rs)
    tag = f'K9a trunk_fwd L=1 {bsz}x{h}x{w}'
    got = trunk_fwd(*one, save=True)
    torch.cuda.synchronize()
    _same_twice(lambda: trunk_fwd(*one, save=True), got, tag)
    stats['K9a']['max_abs_err'] = _check_all(
        f'{tag} fwd', ('out', 'xs', 'h1s'), got,
        trunk_plain(*one, save=True), [1] * 3)
    flops, moved = 2 * conv_flops(px, C, C), nbytes(one, got)
    ms, pms = _timed(stats['K9a'], lambda: trunk_fwd(*one, save=True),
                     lambda: trunk_plain(*one, save=True), flops, moved)
    _print_times(f'{tag} fwd', ms, pms, flops, moved, smi)
    bargs = (got[1], got[2], g, one[1], one[3], rs)
    bgot = trunk_bwd(*bargs)
    torch.cuda.synchronize()
    _same_twice(lambda: trunk_bwd(*bargs), bgot, f'{tag} bwd')
    stats['K9ab']['max_abs_err'] = _check_all(
        f'{tag} bwd', ('dx', 'dW1', 'db1', 'dW2', 'db2'), bgot,
        trunk_bwd_plain(*bargs), [1] * 5)
    flops, moved = 4 * conv_flops(px, C, C), nbytes(bargs, bgot)
    ms, pms = _timed(stats['K9ab'], lambda: trunk_bwd(*bargs),
                     lambda: trunk_bwd_plain(*bargs), flops, moved)
    _print_times(f'{tag} bwd', ms, pms, flops, moved, smi)
    del args, one, got, bgot, bargs
    torch.cuda.empty_cache()

    # K6 at one RDN-B block per call (block 0 of the 16-block stacks)
    c_tot = RDN_G0 * (RDN_C + 1)
    x, wpk, b, wf, bfb = rdn_case(gen, device, bsz, h, w)
    blk = (x, wpk[:1], b[:1], wf[:1], bfb[:1])
    tag = f'K9b rdn_fwd D=1 (one block, C={RDN_C}) {bsz}x{h}x{w}'
    got = rdn_fwd(*blk, save=True)
    torch.cuda.synchronize()
    _same_twice(lambda: rdn_fwd(*blk, save=True), got, tag)
    out_p, bufs_p = rdn_fwd_plain(*blk, save=True)
    stats['K9b']['max_abs_err'] = _check_all(
        tag, ('out', 'buf'), got, (out_p, bufs_p), [2, 2])
    flops = RDN_PAIRS * conv_flops(px, RDN_G0, RDN_G0) \
        + 2.0 * px * c_tot * RDN_G0
    moved = nbytes(blk, got)
    ms, pms = _timed(stats['K9b'], lambda: rdn_fwd(*blk, save=True),
                     lambda: rdn_fwd_plain(*blk, save=True), flops, moved)
    stats['K9b']['device_ms'] = graph_ms(lambda: rdn_fwd(*blk, save=True))
    _print_times(tag, ms, pms, flops, moved, smi,
                 f'; device {stats["K9b"]["device_ms"]:.4f} ms')
    bufs = bufs_p
    gl = _uniform(gen, (bsz, h, w, RDN_G0), 1.0, device, bf)
    zero = torch.zeros_like(gl)
    wtpk = w_t(wpk[:1]).contiguous()
    wft = wf[:1].transpose(1, 2).contiguous()
    cargs = (bufs, 0, gl, zero, wtpk, wft)
    tag = f'K9b rdb_bwd_chain (one block, cotangent rounded) {bsz}x{h}x{w}'
    cgot = rdb_bwd_chain(*cargs)
    torch.cuda.synchronize()
    _same_twice(lambda: rdb_bwd_chain(*cargs), cgot, tag)
    cref = rdb_bwd_chain_plain(*cargs)
    stats['K9bc']['max_abs_err'] = _check_all(
        tag, K6B_STEPS, cgot, cref, list(K6B_STEPS.values()))
    flops = RDN_PAIRS * conv_flops(px, RDN_G0, RDN_G0) \
        + 2 * 2.0 * px * c_tot * RDN_G0
    moved = nbytes(bufs, gl, wtpk, wft, cgot)
    ms, pms = _timed(stats['K9bc'], lambda: rdb_bwd_chain(*cargs),
                     lambda: rdb_bwd_chain_plain(*cargs), flops, moved)
    stats['K9bc']['device_ms'] = graph_ms(lambda: rdb_bwd_chain(*cargs))
    _print_times(tag, ms, pms, flops, moved, smi,
                 f'; device {stats["K9bc"]["device_ms"]:.4f} ms')
    tag = f'K9b rdb_bwd_dw (one block, {RDN_PAIRS} pairs) {bsz}x{h}x{w}'
    dw = rdb_bwd_dw(bufs, 0, cref[1])
    torch.cuda.synchronize()
    _same_twice(lambda: rdb_bwd_dw(bufs, 0, cref[1]), dw, tag)
    stats['K9bw']['max_abs_err'] = _check_all(
        tag, ('dW',), [dw], [rdb_bwd_dw_plain(bufs, 0, cref[1])], [1e-4])
    flops = RDN_PAIRS * conv_flops(px, RDN_G0, RDN_G0)
    moved = nbytes(bufs, cref[1], dw)
    ms, pms = _timed(stats['K9bw'], lambda: rdb_bwd_dw(bufs, 0, cref[1]),
                     lambda: rdb_bwd_dw_plain(bufs, 0, cref[1]), flops,
                     moved)
    stats['K9bw']['device_ms'] = graph_ms(lambda: rdb_bwd_dw(bufs, 0,
                                                             cref[1]))
    _print_times(tag, ms, pms, flops, moved, smi,
                 f'; device {stats["K9bw"]["device_ms"]:.4f} ms')

    # K9c: the 8 dense-layer convs of that block on K2 (c_in 64 (i + 1))
    ws = [_uniform(gen, (3, 3, RDN_G0 * (i + 1), RDN_G0),
                   (9 * RDN_G0 * (i + 1)) ** -0.5, device, bf)
          for i in range(RDN_C)]
    bs = [b[0, i].contiguous() for i in range(RDN_C)]
    buf = x
    for i in range(RDN_C):
        cin = RDN_G0 * (i + 1)
        fargs = (buf, ws[i], bs[i])
        tag = f'K9c dense layer {i} {cin}->64 + ReLU {bsz}x{h}x{w}'
        o = conv3x3_fwd(*fargs, relu=True)
        torch.cuda.synchronize()
        _same_twice(lambda: conv3x3_fwd(*fargs, relu=True), o, tag)
        err = _check_all(tag, ('out',), [o],
                         [conv3x3_plain(*fargs, relu=True)], [1])
        stats['K9c']['max_abs_err'] = max(stats['K9c']['max_abs_err'], err)
        flops, moved = conv_flops(px, cin, RDN_G0), nbytes(fargs, o)
        ms, pms = _timed(stats['K9c'],
                         lambda: conv3x3_fwd(*fargs, relu=True),
                         lambda: conv3x3_plain(*fargs, relu=True), flops,
                         moved, lib_conv(*fargs))
        d_o = _uniform(gen, (bsz, h, w, RDN_G0), 1.0, device, bf)
        bargs = (buf, ws[i], d_o)
        bgot = conv3x3_bwd(*bargs)
        torch.cuda.synchronize()
        _same_twice(lambda: conv3x3_bwd(*bargs), bgot, f'{tag} bwd')
        err = _check_all(f'{tag} bwd', ('dx', 'dW', 'db'), bgot,
                         conv3x3_bwd_plain(*bargs), [1, 1e-4, 1e-4])
        stats['K9cb']['max_abs_err'] = max(stats['K9cb']['max_abs_err'],
                                           err)
        bflops, bmoved = 2 * flops, nbytes(bargs, bgot)
        bms, bpms = _timed(stats['K9cb'], lambda: conv3x3_bwd(*bargs),
                           lambda: conv3x3_bwd_plain(*bargs), bflops,
                           bmoved, lib_conv_bwd(*bargs))
        bwd_split(stats['K9cb'], *bargs, smi, f'K9cb {tag}')
        _print_times(tag, ms, pms, flops, moved, smi,
                     f'; bwd kernel {bms:.4f} ms plain {bpms:.4f} ms')
        buf = torch.cat([buf, o], -1)
    for kid in ('K9c', 'K9cb'):
        st = stats[kid]
        print(f'{kid} the 8 layers of one block: kernel {st["ms"]:.4f} ms '
              f'plain {st["plain_ms"]:.4f} ms bound {st["bound_ms"]:.5f} ms '
              f'library {st["library_ms"]:.4f} ms (benchmark '
              f'{st["library_bench_ms"]:.4f})  [{smi}]')
    del x, wpk, b, wf, bfb, blk, got, bufs, cgot, cref, dw, buf, bufs_p
    torch.cuda.empty_cache()

    # K9d at EDSR True's training shape, res_scale 1.0 and 0.1
    held = {k8a_ops.bwd_plan(rs) for _, rs in k9d_held()}
    for j, rs in enumerate(K9D_SCALES):
        need(k8a_ops.bwd_plan(rs) in held,
             f'K9d at res_scale {rs}: plan not held')
        a = k8_cases(gen, device, bsz, h, w)['K8a'][2][:5]
        _, h1 = resblock_fused_fwd(*a, rs, save_h1=True)
        dargs = (a[0], h1, _uniform(gen, (bsz, h, w, C), 1.0, device, bf),
                 a[1], a[3], rs)
        tag = f'K9d resblock_bwd_fused res_scale {rs} {bsz}x{h}x{w}x{C}'
        got = resblock_bwd_fused(*dargs)
        torch.cuda.synchronize()
        _same_twice(lambda: resblock_bwd_fused(*dargs), got, tag)
        err = _check_all(tag, ('dx', 'dW1', 'db1', 'dW2', 'db2'), got,
                         resblock_bwd_fused_plain(*dargs),
                         [K8_STEPS] + [1e-4] * 4)
        stats['K9d']['max_abs_err'] = max(stats['K9d']['max_abs_err'], err)
        flops, moved = 4 * conv_flops(px, C, C), nbytes(dargs, got[0])
        ms = median_ms(lambda: resblock_bwd_fused(*dargs))
        dev = graph_ms(lambda: resblock_bwd_fused(*dargs), 10, 3)
        host = host_ms(lambda: resblock_bwd_fused(*dargs))
        pms = median_ms(lambda: resblock_bwd_fused_plain(*dargs), 5, 3)
        stock = median_ms(lambda: resblock_fused_bwd(*dargs), 5, 3)
        cudnn = k9d_reference(*dargs)
        ref_dev = graph_ms(cudnn, 10, 3)
        if j == 0:
            record(stats['K9d'], ms, pms, flops, moved)
        _print_times(tag, ms, pms, flops, moved, smi,
                     f'; device {dev:.4f} ms, host {host:.4f} ms; the stock '
                     f'f32 backward of the True route {stock:.4f} ms; bf16 '
                     f'cuDNN (two convolution_backward) {median_ms(cudnn):.4f}'
                     f' ms, device {ref_dev:.4f} ms')
        del got, dargs, a, h1
    torch.cuda.empty_cache()
    return stats


def k9d_reference(x, h1, g, w1, w2, res_scale: float):
    """K9d's work as bf16 cuDNN calls (a reference, not the same
    function: gs and dh1 rounded to bf16): the two
    ``aten.convolution_backward`` of the block's convs, at (h1, W2, gs)
    and (x, W1, dh1) with dh1 that of the first, masked."""
    gs = (g.float() * res_scale).bfloat16()
    dh1 = (lib_conv_bwd(h1, w2, gs)()[0].permute(0, 2, 3, 1)
           * (h1 > 0)).contiguous()
    first, second = lib_conv_bwd(h1, w2, gs), lib_conv_bwd(x, w1, dh1)
    return lambda: (first(), second())


def run_op_paths(device, smi: str) -> dict:
    """Phase 2j's main-path runs of the ops no model keyword reaches (the
    counters set to 0 before each, read after): ``resblock_cs`` (K1 at L
    = 1) and ``resblock_fused_v3`` (K8a forward, K9d backward) at EDSR
    True's training shape, ``rdn_trunk_calls`` (K6 one block per call;
    its forward bit-identical to the grid trunk's) and
    ``rdn_trunk_layers`` (K9c) at RDN-B's trunk shape (16 blocks of 8
    layers, batch 16, LR 32x32), each forward and backward through
    autograd from f32 parameters, against the op's plain path (the
    gradients within STEP_GRAD_TOL of their largest magnitude)."""
    bsz, h, w = TRAIN_BATCH, TRAIN_PATCH // SCALE, TRAIN_PATCH // SCALE
    gen = torch.Generator().manual_seed(SEED)
    f32 = torch.float32
    cb = (9 * C) ** -0.5
    x = _uniform(gen, (bsz, h, w, C), 1.0, device, torch.bfloat16)
    block = [_uniform(gen, s, cb, device, f32)
             for s in ((3, 3, C, C), (C,), (3, 3, C, C), (C,))]
    c_tot = RDN_G0 * (RDN_C + 1)
    rdn = ([_uniform(gen, (RDN_D, 3, 3, RDN_G0 * (i + 1), RDN_G0),
                     (9 * RDN_G0 * (i + 1)) ** -0.5, device, f32)
            for i in range(RDN_C)]
           + [_uniform(gen, (RDN_D, RDN_G0), 0.05, device, f32)
              for _ in range(RDN_C)]
           + [_uniform(gen, (RDN_D, c_tot, RDN_G0), c_tot ** -0.5, device,
                       f32),
              _uniform(gen, (RDN_D, RDN_G0), c_tot ** -0.5, device, f32)])

    bn_prm = [_uniform(gen, (3, 3, C, C), cb, device, f32),
              _uniform(gen, (C,), cb, device, f32),
              1.0 + _uniform(gen, (C,), 0.5, device, f32),
              _uniform(gen, (C,), 0.3, device, f32),
              torch.full((1,), 0.25, device=device),
              _uniform(gen, (3, 3, C, C), cb, device, f32),
              _uniform(gen, (C,), cb, device, f32),
              1.0 + _uniform(gen, (C,), 0.5, device, f32),
              _uniform(gen, (C,), 0.3, device, f32),
              _uniform(gen, (3, 3, C, C), cb, device, f32),
              _uniform(gen, (C,), cb, device, f32),
              1.0 + _uniform(gen, (C,), 0.5, device, f32),
              _uniform(gen, (C,), 0.3, device, f32)]

    def bn_op(reflect):
        def op(prm, plain):
            u, _ = bn_block.bn_resblock(x, *prm[:9], plain, reflect)
            return [bn_block.bn_close(u, x, *prm[9:], plain, reflect)[0]]
        return op

    def op_resblock_cs(prm, plain):
        return [resblock_cs(x, *prm, 0.1, plain)]

    def op_v3(prm, plain):
        return [resblock_fused_v3(x, *prm, 0.1, plain)]

    def rdn_op(fn):
        def op(prm, plain):
            return list(fn(x, prm[:RDN_C], prm[RDN_C:2 * RDN_C], prm[-2],
                           prm[-1], plain))
        return op

    with torch.no_grad():
        rdn_args = (x, rdn[:RDN_C], rdn[RDN_C:2 * RDN_C], rdn[-2], rdn[-1])
        need(torch.equal(torch.cat(rdn_trunk_calls(*rdn_args), -1),
                         rdn_trunk(*rdn_args)),
             'rdn_trunk_calls: forward differs from the grid trunk')

    runs = {}
    # one BN block + the close through the per-function wrappers: F1, F3,
    # B1, B3 twice, F2, B2 once
    bn_calls = {'F1': 2, 'F2': 1, 'F3': 2, 'B1': 2, 'B2': 1, 'B3': 2}
    for key, op, params, expected in (
            ('bn_block_op', bn_op(False), bn_prm,
             {K4_FNS[k]: n for k, n in bn_calls.items()}),
            ('bn_block_r_op', bn_op(True), bn_prm,
             {**{K4R_COUNTERS.get(k, K4_FNS[k]): n
                 for k, n in bn_calls.items()},
              **{K4_FNS[k]: 0 for k in K4R}}),
            ('resblock_cs_op', op_resblock_cs, block,
             {trunk_fwd: 1, trunk_bwd: 1}),
            ('resblock_v3_op', op_v3, block,
             {resblock_fused_fwd: 1, resblock_bwd_fused: 1}),
            ('rdn_calls_op', rdn_op(rdn_trunk_calls), rdn,
             {rdn_fwd: RDN_D, rdb_bwd_chain: RDN_D, rdb_bwd_dw: RDN_D}),
            ('rdn_layers_op', rdn_op(rdn_trunk_layers), rdn,
             # K2's own instances take c_in 64 and 256 (layers 0 and 3),
             # its general path the other six; every dx is 64 -> c_in
             {conv3x3_fwd: RDN_D * 2, K2G_FWD: RDN_D * (RDN_C - 2),
              conv3x3_bwd: RDN_D * RDN_C, K2G_BWD: 0})):
        grads = {}
        for plain in (True, False):
            prm = [t.clone().requires_grad_() for t in params]
            if not plain:
                for k in expected:
                    setattr(*_counter(k), 0)
            outs = op(prm, plain)
            sum(o.float().square().mean() for o in outs).backward()
            torch.cuda.synchronize()
            if not plain:
                runs[key] = {k: getattr(*_counter(k)) for k in expected}
            grads[plain] = [t.grad for t in prm]
        need(runs[key] == expected,
             f'{key}: launches {runs[key]}, expected {expected}')
        # a conv bias right before a batch norm gets f32 rounding noise
        # for its gradient on every path (PRE_BN), and with reflect so
        # does BN2's shift (the block's output cotangent, a transposed
        # reflect conv of the close's zero-mean dy, sums to 0): held in
        # phase 2n
        noise = {'bn_block_op': (1, 6, 10),
                 'bn_block_r_op': (1, 6, 8, 10)}.get(key, ())
        worst = max((gk - gp).abs().max().item() / gp.abs().max().item()
                    for i, (gk, gp) in enumerate(zip(grads[False],
                                                     grads[True]))
                    if i not in noise)
        print(f'{key}: launches ' + ', '.join(
            f'{_counter_name(k)} {v}' for k, v in runs[key].items())
            + f'; gradients kernel vs plain path, worst max_abs/max|ref| '
            f'{worst:.4g} (tol {STEP_GRAD_TOL:.4g})  [{smi}]')
        need(worst <= STEP_GRAD_TOL, f'{key}: gradients')
    return runs


def trunk_reference(x, w1s, b1s, w2s, b2s, res_scale, h1s, g) -> tuple:
    """cuDNN's calls for the work of a K1 trunk (bf16, channels-last; no
    PyTorch call computes a resblock, so this is a target, not a library
    time): the forward, per block two ``F.conv2d`` with their biases,
    ReLU and the scaled skip; the dx chain, per block in reverse two
    ``aten.convolution_backward`` for dx alone (the mask and the skips
    left out). x, g (B, H, W, C); h1s (L, B, H, W, C) the saved h1."""
    cl = torch.channels_last
    w1c = [w.permute(3, 2, 0, 1).contiguous(memory_format=cl) for w in w1s]
    w2c = [w.permute(3, 2, 0, 1).contiguous(memory_format=cl) for w in w2s]
    b1c, b2c = b1s.to(x.dtype), b2s.to(x.dtype)
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    hc = h1s.permute(0, 1, 4, 2, 3)

    def fwd():
        y = xc
        for w1, b1, w2, b2 in zip(w1c, b1c, w2c, b2c):
            h = F.conv2d(y, w1, b1, padding=1).relu_()
            y = torch.add(y, F.conv2d(h, w2, b2, padding=1), alpha=res_scale)
        return y

    def dx(d, inp, w):
        return torch.ops.aten.convolution_backward(
            d, inp, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, False, False])[0]

    def bwd():
        d = gc
        for l in reversed(range(len(w1c))):
            d = dx(dx(d, hc[l], w2c[l]), hc[l], w1c[l])
        return d
    return fwd, bwd


def check_trunk_times(device, smi: str, stats: dict) -> None:
    """Phase 2m. K1 at K1_TIMED's cases: the forward (saving and not) and
    the backward against their plain versions (:func:`_k1_hold`), then
    each call's device time alone (a CUDA graph of the calls), CUDA-event
    time and host time, forward saving and not, the dx chain alone
    (``trunk_chain``) and with its two weight-grad launches, beside
    cuDNN's calls for the same work (:func:`trunk_reference`). The rows
    of the JSON line take theirs: K1 (LR 128x128, not saving), K1b (the
    training shape), K1s / K1sb (86 blocks), K9a / K9ab (one block)."""
    # here, not at the top: tools/tree_timing.py loads this file over
    # trees that have no trunk_chain
    from srtpu_torch.ops.trunk import trunk_chain
    # the rows each K1_TIMED case times, forward and backward
    rows = ((None, 'K1b'), ('K1', None), ('K1s', 'K1sb'), ('K9a', 'K9ab'))
    cb = (9 * C) ** -0.5
    bf, f32 = torch.bfloat16, torch.float32
    for (nb, rs, bsz, h, w), (fwd_id, bwd_id) in zip(K1_TIMED, rows):
        gen = torch.Generator().manual_seed(nb * 1009 + bsz * 31 + h)
        args = (_uniform(gen, (bsz, h, w, C), 1.0, device, bf),
                _uniform(gen, (nb, 3, 3, C, C), cb, device, bf),
                _uniform(gen, (nb, C), cb, device, f32),
                _uniform(gen, (nb, 3, 3, C, C), cb, device, bf),
                _uniform(gen, (nb, C), cb, device, f32), rs)
        g = _uniform(gen, (bsz, h, w, C), 1.0, device, bf)
        steps = {L: (TOL_STEPS['K1'], BWD_DX_STEPS['K1'],
                     BWD_DW_STEPS['K1']),
                 EDSR86_L: (K1S_STEPS, K1S_STEPS, K1S_DW_STEPS)}.get(
                     nb, (1, 1, 1))
        tag = f'K1 L={nb} res_scale {rs} {bsz}x{h}x{w}'
        bargs = _k1_hold(args, g, steps, tag)
        xs, h1s = bargs[:2]
        ref_fwd, ref_bwd = trunk_reference(*args, h1s, g)
        fns = {'fwd (saving)': lambda: trunk_fwd(*args, save=True),
               'fwd (predict)': lambda: trunk_fwd(*args),
               'dx chain': lambda: trunk_chain(h1s, g, args[1], args[3],
                                               rs),
               'bwd (chain + 2 weight grads)': lambda: trunk_bwd(*bargs),
               'cuDNN reference fwd': ref_fwd,
               'cuDNN reference dx (2 convolution_backward a block)':
                   ref_bwd}
        calls = 5 if nb > 1 else 20
        times = {}
        for name, fn in fns.items():
            times[name] = (graph_ms(fn, calls, 3), median_ms(fn, calls, 3),
                           host_ms(fn))
            d, e, hh = times[name]
            print(f'{tag} {name}: device {d:.4f} ms ({d / nb:.5f} a block), '
                  f'CUDA events {e:.4f} ms, host {hh:.4f} ms a call  [{smi}]',
                  flush=True)
        if fwd_id:
            name = 'fwd (saving)' if fwd_id != 'K1' else 'fwd (predict)'
            stats[fwd_id].update(
                device_ms=times[name][0], host_ms=times[name][2],
                reference_ms=times['cuDNN reference fwd'][1],
                reference_device_ms=times['cuDNN reference fwd'][0])
        if bwd_id:
            ref = times['cuDNN reference dx (2 convolution_backward a block)']
            stats[bwd_id].update(
                device_ms=times['bwd (chain + 2 weight grads)'][0],
                host_ms=times['bwd (chain + 2 weight grads)'][2],
                chain_device_ms=times['dx chain'][0],
                reference_ms=ref[1], reference_device_ms=ref[0])
        del args, g, bargs, xs, h1s, ref_fwd, ref_bwd, fns
        torch.cuda.empty_cache()


def png_size(path: Path) -> tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk."""
    head = path.read_bytes()[:24]
    need(head[:8] == b'\x89PNG\r\n\x1a\n' and head[12:16] == b'IHDR',
         f'{path} is not a PNG')
    w, h = struct.unpack('>II', head[16:24])
    return h, w


def run_slice(device, smi: str, model: str = 'EDSR', extra=(),
              expected=EXPECTED_LAUNCHES, rules=None, scale: int = SCALE,
              sizes=SLICE_SIZES, alt=(), profile_all: bool = False,
              precision: str = 'bf16') -> dict:
    """Phase 3 (EDSR) and 5, 7, 9, 11, 13, 14, 19-21, 32 (``extra`` the
    model's CLI flags): predict at ``scale`` through the CLI on images of
    ``sizes``, the launch counters per image (``expected``), the PNGs,
    kernel path against plain path; with ``rules``, device time by kernel
    group of the largest image's forward (``profile_all``: each image's,
    with the largest unmatched kernels); with ``alt`` (flags of another
    route of the same model and weights), that route's forward time per
    image beside. Returns the launch counts of the main-path run."""
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
                '--predict_datasets', 'Demo', '--precision', precision,
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
        print(f'{model} x{scale} {" ".join(extra)} --precision {precision} '
              f'predict CLI (incl. PNG encode + write): '
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
        if record.msg.startswith('epoch %d/%d'):
            self.rows.append(tuple(float(a) for a in record.args[2:-1]))
            self.losses.append(self.rows[-1][0])


# kernel-name substring -> group of the profile, first match wins
# K1's conv1 is K2's own 64 -> 64 instance, as the trunk's close conv
EDSR_PROFILE = (('conv_sm90_kernel<64, 1, 4, 1, false, 6>',
                 'K1 fwd conv2 (K2 engine, EPI 6)'),
                ('conv_sm90_kernel<64, 1, 4, 1, true, 5>',
                 'K1 bwd dx chain (K2 engine TB, EPI 5)'),
                ('trunk_gs_kernel', 'K1 bwd gs pass'),
                ('wgrad', 'weight grads'),
                ('false, 13>', 'K3 fwd (K2 engine, EPI 13: the shuffle in '
                 'the store)'),
                ('true, 14>', 'K3 bwd dx (K2 engine TB, EPI 14: the fine '
                 'map)'),
                ('conv_sm90_kernel<64, 1, 4, 1, false, 0>',
                 'K1 fwd conv1 + K2 close conv (EPI 0)'),
                ('conv_sm90_kernel', 'K2 fwd + bwd dx'))
# K5's conv1 is K2's own 64 -> 64 instance, as the group close convs
RCAN_PROFILE = (('conv_sm90_kernel<64, 1, 4, 1, false, 4>',
                 'K5 fwd conv2 (K2 engine, EPI 4)'),
                ('conv_sm90_kernel<64, 1, 4, 1, true, 5>',
                 'K5 bwd dx chain (K2 engine TB, EPI 5)'),
                ('rcab_pool_mlp_kernel', 'K5 fwd pool + MLP (F2)'),
                ('rcab_gate_kernel', 'K5 fwd gate (F3)'),
                ('rcab_ca_sums_kernel', 'K5 bwd pool sums (B1)'),
                ('rcab_ca_bwd_kernel', 'K5 bwd MLP (B2)'),
                ('rcab_mlp_grads_kernel', 'K5 bwd MLP (B2)'),
                ('rcab_dr2_kernel', 'K5 bwd dr2 (B3)'),
                ('wgrad', 'weight grads'),
                ('conv_sm90_kernel<64, 1, 4, 1, false, 0>',
                 'K5 fwd conv1 + K2 close convs (EPI 0)'),
                ('conv_sm90_kernel', 'K2 bwd dx'))
K4_RULES = (
    ('conv_sm90_kernel<64, 1, 4, 1, false, 9>',
     'K4 F1 / F2 conv + stats partials (K2 engine, EPI 9)'),
    ('conv_sm90_kernel<64, 1, 4, 1, true, 10>',
     'K4 B2 convT + PReLU bwd + BN1 sums (K2 engine TB, EPI 10)'),
    ('conv_sm90_kernel<64, 1, 4, 1, true, 11>',
     'K4 B3 convT + skip (K2 engine TB, EPI 11)'),
    ('bn_act_kernel', 'K4 F2 h1 pass'),
    ('bn_dy_kernel', 'K4 B2 / B3 dy pass + db partials'),
    ('bn_norm_skip_kernel', 'K4 F3 norm + skip'),
    ('bn_sums_kernel', 'K4 B1 sums'),
    ('bn_reduce_kernel', 'K4 fixed-order reductions + finalize'))
SRRESNET_PROFILE = (
    *K4_RULES,
    ('wgrad', 'weight grads'),
    ('false, 13>', 'K3 fwd (K2 engine, EPI 13: the shuffle in the store)'),
    ('true, 14>', 'K3 bwd dx (K2 engine TB, EPI 14: the fine map)'),
    # K2's engine by (N atom, atoms, k16 steps a slice, split, dx): the 5x5
    # 256 -> 16 and its 16 -> 256 dx; the 3x3 64 -> 256 and its dx
    ('conv_sm90_kernel<16, 1, 4,', 'K2 5x5 fwd'),
    ('conv_sm90_kernel<64, 2, 1,', 'K2 5x5 bwd dx'),
    ('conv_sm90_kernel', 'K2 3x3 fwd + bwd dx'))
# K6 on the engines (csrc/conv_sm90.cuh by its EPI argument, csrc/wgrad.cu
# by its K6 argument): the dense layers (EPI 1), the fusion (3), the chain
# (2), dwf (W at k = 1), the pairs
RDN_PROFILE = (('false, 1>', 'K6 fwd dense layers (K2 engine, EPI 1)'),
               ('false, 3>', 'K6 fwd fusion (K2 engine, k = 1, EPI 3)'),
               ('rdn_copy_in_kernel', 'K6 fwd copy-in'),
               ('false, 2>', 'K6b chain: fusion bwd + dx per layer + masks '
                '(K2 engine, EPI 2)'),
               ('rdn_gc_kernel', 'K6b gc, dbf partials'),
               ('wgrad_sm90_kernel<64, 64, 1, true>',
                'K6b dwf (W engine, k = 1)'),
               ('rdn_reduce', 'K6b fixed-order reductions'),
               ('wgrad_sm90_kernel<64, 64, 3, true>',
                'K6w pair weight grads (W engine, pairs mode)'),
               ('wgrad', "weight grads: K2's (W engine)"),
               ('conv_sm90_kernel', 'K2 fwd + bwd dx'))
DDBPN_PROFILE = (
    ('conv_sm90_kernel<64, 2, 2,', 'K2 32->512 (up fwd, down dx)'),
    ('conv_sm90_kernel<32, 1, 4,', 'K2 512->32 (down fwd, up dx)'),
    ('conv_sm90_kernel<16, 3, 4,', 'K2 512->48 (output conv fwd)'),
    ('conv_sm90_kernel<64, 2, 1,', 'K2 48->512 (output conv dx)'),
    ('wgrad_sm90_kernel', 'weight grads (general shapes)'),
    ('wgrad_reduce', 'weight grads fixed-order reductions'),
    ('gemm', '1x1 bottlenecks and head (cuBLAS)'),
    ('nvjet', '1x1 bottlenecks and head (cuBLAS)'))
WDSR_PROFILE = (
    ('wdsr_chain_fwd_kernel<128, false>',
     'K7 chained 1x1 pair -> h2 (h1 in registers)'),
    ('conv_sm90_kernel<64, 2, 4, 1, false, 8>',
     'K7 3x3 + res_scale + skip (K2 engine, EPI 8)'),
    ('conv_sm90_kernel<64, 2, 4, 1, true, 7>',
     'K7b dh2 = convT(gs) + db2 partials (K2 engine TB, EPI 7)'),
    ('wdsr_chain_bwd_kernel', 'K7b chained pointwise bwd (h1 recomputed; '
     'dx, h1, dh1b, db1 partials)'),
    ('wgrad_sm90_kernel<64, 64, 1, true>', 'K7b dW1, dW2 (W engine, k = 1)'),
    ('wdsr_colsum', 'K7b db1, db2 fixed-order sums'),
    ('trunk_gs_kernel', 'K7b gs pass'),
    ('wgrad_sm90_kernel', 'K7b dW3, db3 (W engine)'),
    ('wgrad_reduce', 'K7b weight-grad reductions'),
    ('fprop', 'stock route: cuDNN conv forward'),
    ('dgrad', 'stock route: cuDNN conv dx'),
    ('wgrad', 'stock route: cuDNN conv dW'),
    ('gemm', 'GEMMs (cuBLAS / cuDNN 1x1)'),
    ('nvjet', 'GEMMs (cuBLAS / cuDNN 1x1)'))
SRRESNET_X3_PROFILE = (
    ('conv_sm90_kernel<32, 1, 4,', 'K2 5x5 576->32 (x3 phase-dense fwd)'),
    ('conv_sm90_kernel<64, 3, 2,', 'K2 5x5 32->576 (its dx)'),
    ('wgrad_sm90_kernel', 'weight grads (5x5 576->32 and the rest)'),
    *SRRESNET_PROFILE)
SRGAN_PROFILE = (
    ('bn_fold_ring_kernel', 'K4r B2 / B3 fold ring'),
    ('conv_sm90_kernel<64, 1, 4, 1, false, 9>',
     'K4r F1 / F2 conv + mirrored halo + stats partials (K2 engine, '
     'EPI 9)'),
    ('conv_sm90_kernel<64, 1, 4, 1, true, 10>',
     'K4r B2 convT + fold + PReLU bwd + BN1 sums (K2 engine TB, EPI 10)'),
    ('conv_sm90_kernel<64, 1, 4, 1, true, 11>',
     'K4r B3 convT + fold + skip (K2 engine TB, EPI 11)'),
    *K4_RULES[3:],
    ('wgrad_sm90_kernel', 'K4r weight grads (reflect)'),
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
# the stock ops of the routes without a kernel of the port (cuDNN convs
# in f32, cuBLAS, Adam)
STOCK_RULES = (('dgrad', 'stock: cuDNN conv dx'),
               ('wgrad', 'stock: cuDNN conv dW'),
               ('fprop', 'stock: cuDNN conv forward'),
               ('convolve', 'stock: cuDNN conv'),
               ('gemm', 'stock: GEMMs (cuBLAS / cuDNN)'),
               ('nvjet', 'stock: GEMMs (cuBLAS / cuDNN)'),
               ('multi_tensor_apply', 'Adam'),
               ('reduce', 'stock: reductions (bias grads, pools)'),
               ('elementwise', 'stock: elementwise (casts, masks, skips)'))


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
    copy) or host work. A trace with no device record is taken once
    more: the profiler has now and then handed back none for kernels
    that ran."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        us = sum(_device_us(prof, names).values())
        if us > 0:
            break
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


def fit_data(root: Path, scale: int, patch: int,
             n: int = TRAIN_BATCH) -> Path:
    """A synthetic training set of ``n`` smooth-plus-noise .npy HR images
    of 1.5 patches (TRAIN_BATCH a step: one step per epoch by default)
    and their box-filtered LR at ``scale``, drawn from SEED; returns its
    datasets directory."""
    rng = np.random.default_rng(SEED)
    hr_size = 3 * patch // 2
    data = root / 'datasets'
    hr_dir = data / 'Train' / 'HR'
    lr_dir = data / 'Train' / 'LR' / f'X{scale}'
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    for i in range(n):
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
              alt=(), timing: tuple = (5, 3)) -> dict:
    """Phase 4 (EDSR), 6 (RCAN), 8 (SRResNet), 10, 12, 15, 16, 19-21 and
    32 (``extra`` the model's CLI flags): fit through the CLI at
    ``scale`` on ``patch`` HR patches for ``steps`` steps, the launch
    counters per step (``expected``), the loss, the first kernel-path and
    plain-path steps' gradients (``compare``), five steps' losses, step
    times (CUDA events, ``timing``: steps a window and windows; with
    ``alt``, flags of another route of the same model, that route's step
    time from the same params beside), with ``rules`` the profile.
    Returns the launch counts of the fit run."""
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
                                   launches=timing[0], windows=timing[1])
        PHASE4_STEP_MS.setdefault(model, times[False])   # EDSR: phase 4
        for key, label in labels.items():
            print(f'{model} x{scale} train step ({label}): '
                  f'{times[key]:.3f} ms/step = '
                  f'{TRAIN_BATCH * 1e3 / times[key]:.2f} patches/s '
                  f'(batch {TRAIN_BATCH}, LR {patch // scale}x'
                  f'{patch // scale} -> HR {patch}x{patch}, '
                  f'L1 + Adam)  [{smi}]')
        for key in ((False, 'alt') if alt else (False,)) if rules else ():
            step, state = paths[key]
            _profile(lambda: step(state, lr, hr), times[key], smi, rules,
                     f'{model} x{scale} train step'
                     + ('' if key is False else f', {labels[key]}'), top=3)
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
                 gen, K4_KERNELS + ('wgrad_sm90_kernel', 'wgrad_reduce')),
             'discriminator (3 forward, 2 backward)':
                 _all_device_ms(disc) - sr_ms,
             'VGG19 to relu5_4 (2 forward, 1 backward; f32, TF32 '
             f'{"on" if torch.backends.cudnn.allow_tf32 else "off"})':
                 _all_device_ms(vg) - sr_ms,
             'Adam (G and D)': _all_device_ms(adam)}
    print('SRGAN x4 train step parts, each alone at the step\'s shapes '
          f'(device ms, torch.profiler)  [{smi}]: ' + ', '.join(
              f'{k} {v:.3f}' for k, v in parts.items()))


def _gan_argv(data: Path, run: Path) -> list:
    """Phase 18's ``fit --model SRGAN`` command line."""
    return ['fit', '--model', 'SRGAN', '--scale_factor', str(SCALE),
            *SRGAN_ARGS, '--datasets_dir', str(data), '--train_datasets',
            'Train', '--batch_size', str(TRAIN_BATCH), '--patch_size',
            str(TRAIN_PATCH), '--optimizer_params', 'lr=1e-4',
            '--max_epochs', str(TRAIN_STEPS), '--precision', 'bf16',
            '--device', 'cuda', '--seed', str(SEED), '--default_root_dir',
            str(run)]


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic algorithms and no benchmark mode inside the
    block, the settings restored after: the stock f32 convs of the SRGAN
    step (D, VGG19, the f32 path's generator) otherwise take algorithms
    whose sums change order from call to call, and the held step's
    invariants sit at that noise."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def gan_held_step(net, vgg, lr, hr, scale: int) -> tuple[dict, list]:
    """Phase 18's held step: from ``net``'s parameters and one batch, a
    kernel-path, a plain-path and an f32 step (cuDNN deterministic), every
    generator gradient and each block's BN2 dy of the kernel path held to
    the f32 step (as phase 8). Returns the two paths ({plain: (step,
    state)}, each one step on) and the (error / limit, text) rows."""
    def path(plain, dtype=torch.bfloat16):
        m = copy.deepcopy(net)
        m.generator.dtype = m.discriminator.dtype = dtype
        return (make_gan_train_step(vgg_loss=vgg, plain=plain),
                create_gan_state(m, 1e-4))
    scales, rk, rp, rf = {}, [], [], []
    with _cudnn_deterministic():
        paths = {False: path(False), True: path(True)}
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
    return paths, rows + dy_rows


def gan_held_repeat(device, smi: str, runs: int = 4) -> None:
    """Phase 18's held step ``runs`` times on one set of parameters and
    batch: every error / limit ratio must repeat bit for bit (F13)."""
    with tempfile.TemporaryDirectory(prefix='srtpu_smoke_gan_') as tmp:
        data = fit_data(Path(tmp), SCALE, TRAIN_PATCH)
        argv = _gan_argv(data, Path(tmp) / 'run')
        net = cli.build_model(cli.build_parser().parse_args(argv), device)
        net.train()
        lr, hr = fit_batches(data, SCALE, TRAIN_PATCH, device, 1)[0]
        vgg = VGGLoss(device=device)
        seen = []
        for i in range(runs):
            rows = gan_held_step(net, vgg, lr, hr, SCALE)[1]
            seen.append([r for r, _ in rows])
            print(f'held step {i + 1} of {runs}: largest error/limit '
                  f'{max(seen[-1])!r}; per block dy, invariant: '
                  + ', '.join(repr(r) for r in seen[-1][-2:])
                  + f'  [{smi}]')
        need(all(r == seen[0] for r in seen),
             f'the held SRGAN step moved between calls: {seen}')
        print(f'held SRGAN step: {runs} calls, every one of its '
              f'{len(seen[0])} error/limit ratios the same each call')


def run_gan_train(device, smi: str) -> dict:
    """Phase 18. ``fit --model SRGAN --use_pallas cs`` through the CLI at
    batch 16, patch 128, TRAIN_STEPS adversarial steps: the launch
    counters per step, g_loss and d_loss finite, the running statistics
    moved; from one set of params and batch, a kernel-path and a
    plain-path step held to an f32 step (:func:`gan_held_step`, cuDNN
    deterministic); five steps' losses; the step's time on
    both paths (TF32 at PyTorch's default, on, for the VGG19's f32 convs
    as the CLI runs them; the kernel path also with it off); the device
    share and time by group. Returns the launch counts of the fit run."""
    scale, patch, steps = SCALE, TRAIN_PATCH, TRAIN_STEPS
    with tempfile.TemporaryDirectory(prefix='srtpu_smoke_gan_') as tmp:
        data = fit_data(Path(tmp), scale, patch)
        argv = _gan_argv(data, Path(tmp) / 'run')
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

        net = cli.build_model(cli.build_parser().parse_args(argv), device)
        net.train()
        batches = fit_batches(data, scale, patch, device)
        vgg = VGGLoss(device=device)
        paths, _ = gan_held_step(net, vgg, *batches[0], scale)
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


def val_data(root: Path, sizes, name: str = 'Val') -> Path:
    """An eval set ``<root>/datasets/<name>``: smooth-plus-noise .npy HR
    images of ``sizes`` drawn from SEED and their box-filtered LR at
    SCALE (``LR/X4``); returns the datasets directory."""
    rng = np.random.default_rng(SEED)
    data = root / 'datasets'
    hr_dir, lr_dir = data / name / 'HR', data / name / 'LR' / f'X{SCALE}'
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    for h, w in sizes:
        lo = rng.random((h // 8 + 1, w // 8 + 1, 3))
        hr = (np.kron(lo, np.ones((8, 8, 1)))[:h, :w] * 0.8
              + rng.random((h, w, 3)) * 0.2).astype(np.float32)
        np.save(hr_dir / f'img{h}x{w}.npy', hr)
        lr = hr.reshape(h // SCALE, SCALE, w // SCALE, SCALE, 3).mean((1, 3))
        np.save(lr_dir / f'img{h}x{w}.npy', lr.astype(np.float32))
    return data


def _cli_counted(argv, expected, what: str) -> tuple[dict, float, str]:
    """``cli.main(argv)`` with every counter of ``expected`` set to 0
    before it: (the counts after, its wall seconds, its stdout)."""
    for k in expected:
        setattr(*_counter(k), 0)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    need(rc == 0, f'{what} returned {rc}')
    return {k: getattr(*_counter(k)) for k in expected}, wall, out.getvalue()


def _need_counts(counts: dict, expected: dict, times: int, what: str):
    for k, per in expected.items():
        need(counts[k] == per * times,
             f'{what}: {_counter_name(k)} {counts[k]} launches, expected '
             f'{per} x {times}')


def _metrics_at(fns: dict, sr, hr, mask) -> dict:
    with torch.inference_mode():
        return {k: float(fn(sr, hr, mask=mask)) for k, fn in fns.items()}


def run_validate(device, smi: str, model: str = 'EDSR', extra=(),
                 expected=EXPECTED_LAUNCHES, full: bool = True) -> dict:
    """Phase 25: ``python -m srtpu_torch validate``'s own function on
    VAL_HR_SIZES with PSNR, SSIM and MS-SSIM, the launch counters per
    image (``expected``); per image, the kernel path's metrics against
    the plain path's and the masked values against the unpadded image's;
    the printed means against the per-image values; with ``full``, also
    the card's metric functions against the CPU's on the same SR and HR,
    and eval ms per image split into forward and metrics, kernel and
    plain paths. Returns the launch counts of the CLI run."""
    with tempfile.TemporaryDirectory(prefix='srtpu_smoke_val_') as tmp:
        data = val_data(Path(tmp), VAL_HR_SIZES)
        argv = ['validate', '--model', model, '--scale_factor', str(SCALE),
                '--n_feats', str(C), '--n_resblocks', str(L), *extra,
                '--datasets_dir', str(data), '--eval_datasets', 'Val',
                '--metrics', *VAL_METRICS, '--precision', 'bf16',
                '--device', 'cuda', '--seed', str(SEED),
                '--default_root_dir', str(Path(tmp) / 'out')]
        _cli_counted(argv, {}, 'warm-up validate')  # cuDNN plans, allocator
        n = len(VAL_HR_SIZES)
        counts, wall, out = _cli_counted(argv, expected, f'{model} validate')
        _need_counts(counts, expected, n, f'{model} validate')
        printed = dict(ln.split(': ') for ln in out.strip().splitlines())
        need(list(printed) == sorted(f'Val/{m}' for m in VAL_METRICS),
             f'validate printed {list(printed)}')
        print(f'{model} x{SCALE} validate CLI: {n} images in {wall:.3f} s = '
              f'{n / wall:.3f} images/s (incl. .npy reads, padding, H2D); '
              + ', '.join(f'{k} {v}' for k, v in printed.items())
              + f'  [{smi}]')

        net = cli.build_model(cli.build_parser().parse_args(argv),
                              device).eval()
        fns = build_metrics(VAL_METRICS)
        steps = {False: make_eval_step(net, fns),
                 True: make_eval_step(net, fns, plain=True)}
        dm = SRData(datasets_dir=str(data), eval_datasets=['Val'],
                    scale_factor=SCALE)
        dm.setup('validate')
        kernel_vals = {m: [] for m in VAL_METRICS}
        for batch in dm.eval_loaders()[0]:
            lr, hr, mask = (torch.from_numpy(a).to(device)
                            for a in (batch.lr, batch.hr, batch.mask))
            hs, ws = batch.hr_size
            tag = f'{model} validate {batch.names[0]} (LR ' \
                  f'{tuple(lr.shape[1:3])}, HR {hs}x{ws})'
            sr, res_k = steps[False](lr, hr, mask)
            _, res_p = steps[True](lr, hr, mask)
            res_k = {k: float(v) for k, v in res_k.items()}
            res_p = {k: float(v) for k, v in res_p.items()}
            need(sr.shape == hr.shape and bool(torch.isfinite(sr).all()),
                 f'{tag}: SR {tuple(sr.shape)} or non-finite')
            for m in VAL_METRICS:
                need(np.isfinite(res_k[m]), f'{tag}: {m} {res_k[m]}')
                kernel_vals[m].append(res_k[m])
            d_path = {m: abs(res_k[m] - res_p[m]) for m in VAL_METRICS}
            hr32 = hr.float().clamp(0, 1)
            d_cpu = {m: 0.0 for m in VAL_METRICS}
            if full:    # the card's metric functions against the CPU's
                cpu = _metrics_at(fns, sr.cpu(), hr32.cpu(), mask.cpu())
                d_cpu = {m: abs(res_k[m] - cpu[m]) for m in VAL_METRICS}
            # masked (padded) against the unpadded image, on the card
            unpad = _metrics_at(fns, sr[:, :hs, :ws].contiguous(),
                                hr32[:, :hs, :ws].contiguous(), None)
            d_pad = {m: abs(res_k[m] - unpad[m]) for m in VAL_METRICS}
            print(f'{tag}: kernel ' + ' '.join(
                f'{m} {res_k[m]:.6f}' for m in VAL_METRICS) + '; plain '
                + ' '.join(f'{m} {res_p[m]:.6f}' for m in VAL_METRICS)
                + ' | |kernel - plain| ' + ' '.join(
                    f'{m} {d_path[m]:.3g} (tol {VAL_PATH_TOL[m]:.3g})'
                    for m in VAL_METRICS) + (' | |card - CPU| ' + ' '.join(
                        f'{m} {d_cpu[m]:.3g}' for m in VAL_METRICS)
                    if full else '') + ' | |masked - unpadded| '
                + ' '.join(f'{m} {d_pad[m]:.3g}' for m in VAL_METRICS)
                + ' (tol ' + ' '.join(f'{m} {METRIC_DEVICE_TOL[m]:.3g}'
                                      for m in VAL_METRICS) + f')  [{smi}]')
            for m in VAL_METRICS:
                need(d_path[m] <= VAL_PATH_TOL[m], f'{tag}: {m} kernel vs '
                     'plain path')
                need(d_cpu[m] <= METRIC_DEVICE_TOL[m], f'{tag}: {m} card '
                     'vs CPU')
                need(d_pad[m] <= METRIC_DEVICE_TOL[m], f'{tag}: {m} masked '
                     'vs unpadded')
            if not full:
                continue
            with torch.inference_mode():
                fwd = median_ms(lambda: net(lr), launches=1)
                fwd_p = median_ms(lambda: net(lr, plain=True), launches=1)
                met = median_ms(lambda: [fn(sr, hr32, mask=mask)
                                         for fn in fns.values()], launches=1)
                per = {m: median_ms(lambda: fn(sr, hr32, mask=mask),
                                    launches=1) for m, fn in fns.items()}
            print(f'{tag} eval ms (CUDA events, median of 5): forward '
                  f'{fwd:.3f} + metrics {met:.3f} = {fwd + met:.3f} ms = '
                  f'{1e3 / (fwd + met):.2f} images/s (plain path: forward '
                  f'{fwd_p:.3f}, total {fwd_p + met:.3f} = '
                  f'{1e3 / (fwd_p + met):.2f} images/s); metrics alone '
                  + ', '.join(f'{m} {v:.3f}' for m, v in per.items())
                  + f'  [{smi}]')
        for m in VAL_METRICS:
            mean = float(np.mean(kernel_vals[m]))
            need(abs(float(printed[f'Val/{m}']) - mean) <= 1e-4,
                 f'printed Val/{m} {printed[f"Val/{m}"]} vs {mean}')
    return counts


def _tile_batches(h: int, w: int, tile: int, overlap: int,
                  batch: int) -> int:
    """Forward calls of ``make_tiled_apply`` on one h x w LR image."""
    n = len(_anchors(max(h, tile), tile, tile - 2 * overlap)) \
        * len(_anchors(max(w, tile), tile, tile - 2 * overlap))
    return -(-n // min(batch, n))


def run_tiled(device, smi: str, stats: dict) -> dict:
    """Phase 26: K1-K3 at the tiled steps' 16 x 80 x 80 batch against
    their plain versions; EDSR ``validate`` and ``predict`` with
    ``--eval_tile 80 --eval_tile_overlap 8`` on the 2048x1408 image
    through the CLI (K1-K3 on every 16-tile batch), the predict PNG
    byte-equal to the tiled step's SR checked here; the tiled kernel path
    against the tiled plain path and the direct forward; the host
    ``--predict_tile`` route once; tiled ms against direct ms. Returns
    the launch counts of the three CLI runs by run."""
    for kid, label, fn, plain, args, _, _ in kernel_cases(
            TILE, TILE, device, TILE_BATCH):
        if kid == 'K25':
            continue
        got = fn(*args)
        torch.cuda.synchronize()
        err, tol, top = _err(got, plain(*args), TOL_STEPS[kid])
        ms = median_ms(lambda: fn(*args))
        plain_ms = median_ms(lambda: plain(*args))
        print(f'{kid} {label} (the tiled steps\' batch): max_abs {err:.4g} '
              f'rel {err / top:.3g} tol {tol:.4g} | kernel {ms:.4f} ms '
              f'plain {plain_ms:.4f} ms  [{smi}]')
        need(np.isfinite(err) and err <= tol, f'{label}: {err} > {tol}')
        stats[kid]['max_abs_err'] = max(stats[kid]['max_abs_err'], err)

    runs = {}
    hr_h, hr_w = VAL_HR_SIZES[-1]
    lh, lw = hr_h // SCALE, hr_w // SCALE
    with tempfile.TemporaryDirectory(prefix='srtpu_smoke_tile_') as tmp:
        data = val_data(Path(tmp), VAL_HR_SIZES[-1:], 'Big')
        net_args = ['--model', 'EDSR', '--scale_factor', str(SCALE),
                    '--n_feats', str(C), '--n_resblocks', str(L),
                    '--datasets_dir', str(data), '--precision', 'bf16',
                    '--device', 'cuda', '--seed', str(SEED)]
        val_argv = ['validate', *net_args, '--eval_datasets', 'Big',
                    '--metrics', *VAL_METRICS, *TILE_ARGS,
                    '--default_root_dir', str(Path(tmp) / 'v')]
        nb = _tile_batches(lh, lw, TILE, TILE_OVERLAP, TILE_BATCH)
        counts, wall, out = _cli_counted(val_argv, EXPECTED_LAUNCHES,
                                         'tiled validate')
        _need_counts(counts, EXPECTED_LAUNCHES, nb, 'tiled validate')
        runs['edsr_tiled_validate'] = counts
        print(f'EDSR x4 validate --eval_tile {TILE} --eval_tile_overlap '
              f'{TILE_OVERLAP}, LR {lh}x{lw}: {nb} batches of '
              f'{TILE_BATCH} tiles, K1-K3 on each (' + ', '.join(
                  f'{_counter_name(k)} {v}' for k, v in counts.items())
              + f'); {wall:.3f} s; ' + out.strip().replace('\n', ', ')
              + f'  [{smi}]')
        # predict pads the LR to eval_tile multiples (edge), then tiles
        ph, pw = -(-lh // TILE) * TILE, -(-lw // TILE) * TILE
        nb_p = _tile_batches(ph, pw, TILE, TILE_OVERLAP, TILE_BATCH)
        outs = {}
        for key, extra, per in (
                ('edsr_tiled_predict', TILE_ARGS, nb_p),
                ('edsr_host_tiles', ['--predict_tile', str(HOST_TILE),
                                     '--predict_tile_overlap',
                                     str(HOST_OVERLAP)],
                 len(_anchors(lh, HOST_TILE, HOST_TILE - 2 * HOST_OVERLAP))
                 * len(_anchors(lw, HOST_TILE,
                                HOST_TILE - 2 * HOST_OVERLAP)))):
            outs[key] = Path(tmp) / key
            argv = ['predict', *net_args, '--predict_datasets', 'Big',
                    *extra, '--default_root_dir', str(outs[key])]
            counts, wall, _ = _cli_counted(argv, EXPECTED_LAUNCHES, key)
            _need_counts(counts, EXPECTED_LAUNCHES, per, key)
            need(png_size(outs[key] / 'Big' / f'img{hr_h}x{hr_w}.png')
                 == (hr_h, hr_w), f'{key}: PNG size')
            runs[key] = counts
            print(f'EDSR x4 predict {" ".join(extra)}: {per} forward calls '
                  f'(' + ', '.join(f'{_counter_name(k)} {v}'
                                   for k, v in counts.items())
                  + f'), {wall:.3f} s incl. PNG encode  [{smi}]')

        net = cli.build_model(cli.build_parser().parse_args(
            ['predict', *net_args, '--predict_datasets', 'Big']),
            device).eval()
        lr_np = np.load(data / 'Big' / 'LR' / 'X4'
                        / f'img{hr_h}x{hr_w}.npy')[None]
        lr = torch.from_numpy(lr_np).to(device)
        tiled_k = make_tiled_predict_step(net, SCALE, TILE, TILE_OVERLAP,
                                          TILE_BATCH)
        tiled_p = make_tiled_predict_step(net, SCALE, TILE, TILE_OVERLAP,
                                          TILE_BATCH, plain=True)
        direct = make_predict_step(net)
        sr_k, sr_p, sr_d = tiled_k(lr), tiled_p(lr), direct(lr)
        need(sr_k.shape == (1, hr_h, hr_w, 3)
             and bool(torch.isfinite(sr_k).all()), 'tiled SR')
        diff = (sr_k - sr_p).abs()
        err, mean = diff.max().item(), diff.mean().item()
        seam = (sr_k - sr_d).abs()
        print(f'EDSR x4 tiled predict step, LR {lh}x{lw}: kernel vs plain '
              f'path max_abs {err:.4g} (tol {SLICE_MAX_TOL:.4g}) mean_abs '
              f'{mean:.3g} (tol {SLICE_MEAN_TOL:.3g}); tiled vs direct '
              f'(kernel path) max_abs {seam.max().item():.4g} mean_abs '
              f'{seam.mean().item():.3g} (srtpu\'s bf16 seams, ROADMAP F2: '
              f'about {F2_SEAM:g})  [{smi}]')
        need(err <= SLICE_MAX_TOL and mean <= SLICE_MEAN_TOL,
             'tiled kernel path vs tiled plain path')
        # the CLI's PNGs are these routes' SR images, saved the same way
        src = np.pad(lr_np, ((0, 0), (0, ph - lh), (0, pw - lw), (0, 0)),
                     mode='edge')
        host = tiled_predict(
            lambda t: direct(torch.from_numpy(t).to(device)).cpu().numpy(),
            lr_np[0], SCALE, tile=HOST_TILE, overlap=HOST_OVERLAP)
        for key, sr_np in (
                ('edsr_tiled_predict', tiled_k(torch.from_numpy(src).to(
                    device))[0, :hr_h, :hr_w].cpu().numpy()),
                ('edsr_host_tiles', host[:hr_h, :hr_w])):
            check = Path(tmp) / f'{key}.png'
            save_image(sr_np, check)
            need(check.read_bytes() == (outs[key] / 'Big' /
                                        f'img{hr_h}x{hr_w}.png').read_bytes(),
                 f'{key}: the PNG differs from the checked SR')
        t_k = median_ms(lambda: tiled_k(lr), launches=1)
        t_p = median_ms(lambda: tiled_p(lr), launches=1)
        t_d = median_ms(lambda: direct(lr), launches=1)
        print(f'EDSR x4 predict step at LR {lh}x{lw} (CUDA events, median '
              f'of 5): tiled {t_k:.3f} ms ({nb} batches of {TILE_BATCH} '
              f'{TILE}x{TILE} tiles, overlap {TILE_OVERLAP}; plain path '
              f'{t_p:.3f}) against direct {t_d:.3f} ms  [{smi}]')
    return runs


def _recorded_steps(losses: dict, crash_at: int | None = None):
    """Patch ``loop.make_train_step`` so that each step's loss tensor is
    kept in ``losses`` by the step the state enters at (read after the
    run), and, with ``crash_at``, so that the step entering there raises
    before it does anything. Returns the undo."""
    real = train_loop.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def recorded(state, lr, hr):
            if state.step == crash_at:
                raise RuntimeError('planted fault at the start of epoch 3')
            at = state.step
            logs = step(state, lr, hr)
            losses[at] = logs['loss']
            return logs
        return recorded
    train_loop.make_train_step = make
    return lambda: setattr(train_loop, 'make_train_step', real)


def _fitval_run(argv, expected, what, crash_at=None):
    """``cli.main(argv)`` counted (``_cli_counted``), each step's loss by
    step; a planted crash must come out of it as the RuntimeError."""
    losses: dict = {}
    undo = _recorded_steps(losses, crash_at)
    try:
        if crash_at is None:
            counts, wall, _ = _cli_counted(argv, expected, what)
        else:
            counts, wall = {}, 0.0
            try:
                cli.main(argv)
            except RuntimeError as e:
                need('planted fault' in str(e), f'{what}: {e}')
            else:
                need(False, f'{what}: the planted crash did not raise')
    finally:
        undo()
    return counts, wall, {k: float(v) for k, v in losses.items()}


def _jsonl(path: Path) -> list[dict]:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def _max_diff(a: dict, b: dict) -> float:
    return max((a[k].float() - b[k].float()).abs().max().item() for k in a)


def run_fit_val(device, smi: str, then=None) -> dict:
    """Phase 27 (the module note). Returns the launch counts of (a) and
    of (c)'s ``validate`` / ``predict --checkpoint``; with ``then``, also
    those of ``then(device, smi, tmp, checkpoints, assets_s)`` on its
    run (phase 28: ``run_phase28``), before the run is deleted."""
    per_step = {k: v * FITVAL_EPOCHS * FITVAL_SPE
                for k, v in STEP_LAUNCHES.items()}
    images = len(FITVAL_HR_SIZES) * FITVAL_PASSES
    expected = {k: per_step[k] + EXPECTED_LAUNCHES.get(k, 0) * images
                for k in STEP_LAUNCHES}
    with tempfile.TemporaryDirectory(prefix='srtpu_smoke_fitval_') as tmp:
        tmp = Path(tmp)
        data = fit_data(tmp, SCALE, TRAIN_PATCH,
                        n=TRAIN_BATCH * FITVAL_SPE)
        val_data(tmp, FITVAL_HR_SIZES)
        base = ['fit', '--model', 'EDSR', '--scale_factor', str(SCALE),
                '--n_feats', str(C), '--n_resblocks', str(L),
                '--datasets_dir', str(data), '--train_datasets', 'Train',
                '--batch_size', str(TRAIN_BATCH), '--patch_size',
                str(TRAIN_PATCH), '--losses', 'l1', '--optimizer', 'ADAM',
                '--optimizer_params', 'lr=1e-4', '--max_epochs',
                str(FITVAL_EPOCHS), '--precision', 'bf16', '--device',
                'cuda', '--seed', str(SEED)]
        val = ['--eval_datasets', 'Val', '--check_val_every_n_epoch', '2',
               '--save_top_k', '1', '--log_weights_every_n_epochs', '2']

        def argv(run, *extra):
            return base + ['--default_root_dir', str(tmp / run), *extra]
        assets_s = []       # the run assets' wall seconds, each fit
        real_assets = Trainer._log_run_assets

        def timed_assets(self, *args):
            t0 = time.perf_counter()
            real_assets(self, *args)
            assets_s.append(time.perf_counter() - t0)
        Trainer._log_run_assets = timed_assets
        try:
            with _cudnn_deterministic():
                _, wall0, _ = _fitval_run(argv('a0'), {}, 'fit without val')
                counts, wall, loss_a = _fitval_run(argv('a', *val), expected,
                                                   'fit with validation')
        finally:
            Trainer._log_run_assets = real_assets
        with _cudnn_deterministic():
            _fitval_run(argv('b', *val), {}, 'the crashing fit',
                        crash_at=FITVAL_CRASH_STEP)
            _, _, loss_b = _fitval_run(
                argv('b', *val, '--ckpt_path', 'last'), {}, 'the resume')
        _need_counts(counts, expected, 1, 'fit with validation (the '
                     f'counts: per step x {FITVAL_EPOCHS * FITVAL_SPE} '
                     f'+ per image x {images})')
        print('EDSR x4 fit with validation: launches ' + ', '.join(
            f'{_counter_name(k)} {counts[k]}' for k in expected)
            + f' = per step x {FITVAL_EPOCHS * FITVAL_SPE} + per eval '
            f'image x {images} (the sanity pass and 2 val passes on 2 '
            'images)')

        # (a) top-k, last, hparams, finite values
        ckpts = tmp / 'a' / 'checkpoints'
        recs = _jsonl(tmp / 'a' / 'metrics.jsonl')
        vals = {r['step'] // FITVAL_SPE: r for r in recs if 'Val/PSNR' in r}
        need(sorted(vals) == [2, 4], f'val passes at epochs {sorted(vals)}')
        need(all(np.isfinite(v) for r in recs for v in r.values()),
             'a logged value is not finite')
        best = max(vals, key=lambda e: (vals[e]['Val/PSNR'], e))
        top = sorted(int(d.name) for d in (ckpts / 'top').iterdir())
        need(top == [best], f'checkpoints/top {top}, best Val/PSNR epoch '
             f'{best}')
        need((ckpts / 'last' / 'state.pt').is_file()
             and (ckpts / 'hparams.json').is_file(),
             'no last checkpoint or hparams.json')
        print('EDSR x4 fit with validation: Val/PSNR ' + ', '.join(
            f'epoch {e} {vals[e]["Val/PSNR"]:.6f}' for e in sorted(vals))
            + f'; checkpoints/top {top}; last, hparams.json; '
            f'{len(recs)} metrics.jsonl lines, all finite')
        print(f'EDSR x4 fit CLI, {FITVAL_EPOCHS} epochs x {FITVAL_SPE} '
              f'steps: {wall:.3f} s with validation (sanity pass + 2 val '
              f'passes on HR 512x512 and 1000x680, the last pass writing '
              f'each SR and its centre crop as PNG, top-k and last saves), '
              f'{wall0:.3f} s without (last saves only)  [{smi}]')

        # (b) the resume against (a), bit for bit
        steps = range(FITVAL_CRASH_STEP, FITVAL_EPOCHS * FITVAL_SPE)
        need(sorted(loss_b) == list(steps), f'resumed steps {sorted(loss_b)}')
        d_loss = max(abs(loss_b[k] - loss_a[k]) for k in steps)
        w_a = torch.load(tmp / 'a' / 'final_weights.pt', weights_only=True)
        w_b = torch.load(tmp / 'b' / 'final_weights.pt', weights_only=True)
        d_w = _max_diff(w_a, w_b)
        last_a = [r for r in recs if 'Val/PSNR' in r][-1]
        last_b = [r for r in _jsonl(tmp / 'b' / 'metrics.jsonl')
                  if 'Val/PSNR' in r][-1]
        d_val = max(abs(last_a[k] - last_b[k]) for k in ('Val/PSNR',
                                                         'Val/SSIM'))
        print(f'EDSR x4 crash at step {FITVAL_CRASH_STEP} (epoch 3) and '
              f'--ckpt_path last: epochs 3-4 losses max |d| {d_loss:.3g}, '
              f'final weights max |d| {d_w:.3g}, last val pass max |d| '
              f'{d_val:.3g} (all must be 0)')
        need(d_loss == 0 and d_w == 0 and d_val == 0,
             'the resumed run is not (a) bit for bit')

        # (c) validate / predict --checkpoint
        common = ['--device', 'cuda']
        n_val = len(FITVAL_HR_SIZES)
        runs = {'fitval_edsr': counts}
        runs['fitval_validate_ckpt'], _, _ = _cli_counted(
            ['validate', '--checkpoint', str(ckpts), '--default_root_dir',
             str(tmp / 'c'), *common], EXPECTED_LAUNCHES,
            'validate --checkpoint')
        _need_counts(runs['fitval_validate_ckpt'], EXPECTED_LAUNCHES, n_val,
                     'validate --checkpoint')
        got = _jsonl(tmp / 'c' / 'metrics.jsonl')[-1]
        d_c = max(abs(got[k] - vals[best][k]) for k in ('Val/PSNR',
                                                         'Val/SSIM'))
        print(f'validate --checkpoint (epoch {best}): ' + ', '.join(
            f'{k} {got[k]:.6f}' for k in ('Val/PSNR', 'Val/SSIM'))
            + f'; against the fit\'s val pass max |d| {d_c:.3g} (tol 1e-6)')
        need(d_c <= 1e-6, 'validate --checkpoint against the fit')
        state = torch.load(ckpts / 'top' / str(best) / 'state.pt',
                           weights_only=True)
        torch.save(state['model'], tmp / 'w.pt')
        net = ['--n_feats', str(C), '--n_resblocks', str(L)]
        pred = ['predict', '--datasets_dir', str(tmp / 'datasets'),
                '--predict_datasets', 'Val', *common]
        runs['fitval_predict_ckpt'], _, _ = _cli_counted(
            pred + ['--checkpoint', str(ckpts), '--default_root_dir',
                    str(tmp / 'pc')], EXPECTED_LAUNCHES,
            'predict --checkpoint')
        _need_counts(runs['fitval_predict_ckpt'], EXPECTED_LAUNCHES, n_val,
                     'predict --checkpoint')
        _cli_counted(pred + ['--weights', str(tmp / 'w.pt'), *net,
                             '--default_root_dir', str(tmp / 'pw')], {},
                     'predict --weights')
        pngs = sorted(p.name for p in (tmp / 'pw' / 'Val').iterdir())
        need(len(pngs) == 2 * len(FITVAL_HR_SIZES) and all(
            (tmp / 'pc' / 'Val' / n).read_bytes()
            == (tmp / 'pw' / 'Val' / n).read_bytes() for n in pngs),
            'predict --checkpoint PNGs differ from predict --weights')
        print('validate / predict --checkpoint: launches ' + '; '.join(
            ', '.join(f'{_counter_name(k)} {v}' for k, v in runs[key].items())
            for key in ('fitval_validate_ckpt', 'fitval_predict_ckpt'))
            + f' = per image x {n_val} each (the model rebuilt from '
            f'hparams.json on the kernel route); {len(pngs)} PNGs of '
            'predict --checkpoint byte-equal to predict --weights on the '
            'same state')

        # checkpoint save / restore and the val pass, timed
        args = cli.build_parser().parse_args(argv('t'))
        model = cli.build_model(args, device)
        st = TrainState(model, build_optimizer('ADAM', ['lr=1e-4'],
                                               model.parameters()))
        lr, hr = fit_batches(data, SCALE, TRAIN_PATCH, device, n=1)[0]
        make_train_step(parse_losses('l1'))(st, lr, hr)
        mngr = CheckpointManager(tmp / 't' / 'checkpoints',
                                 monitor='Val/PSNR', save_top_k=1)
        save_ms, restore_ms = [], []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mngr.save(i + 1, st, {'Val/PSNR': float(i)})
            save_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            mngr.restore_last(st)
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        mb = (tmp / 't' / 'checkpoints' / 'last' / 'state.pt').stat(
        ).st_size / 2 ** 20
        trainer = Trainer(TrainerConfig(default_root_dir=str(tmp / 'v')))
        dm = SRData(datasets_dir=str(tmp / 'datasets'),
                    eval_datasets=['Val'], scale_factor=SCALE)
        trainer.validate(model, dm)         # warm
        val_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.validate(model, dm)
            torch.cuda.synchronize()
            val_ms.append((time.perf_counter() - t0) * 1e3
                          / len(FITVAL_HR_SIZES))
        trainer.close()
        print(f'EDSR x4 checkpoint ({mb:.2f} MiB: model, Adam state): save '
              f'(top-k and last) {np.median(save_ms):.3f} ms, restore_last '
              f'{np.median(restore_ms):.3f} ms (host clock, median of 5); '
              f'val pass {np.median(val_ms):.3f} ms an image (PSNR, SSIM; '
              f'HR 512x512 and 1000x680; host clock, median of 3, '
              f'incl. .npy reads, padding, H2D)  [{smi}]')
        if then is not None:
            runs.update(then(device, smi, tmp, ckpts, assets_s))
    return runs


# ----------------------------------------------------------- phase 28

# Phase 28's routes exported at 2 blocks or groups: (label, model, flags)
EXPORT_ROUTES = (
    ('RCAN cs', 'RCAN', ['--n_resgroups', '2', '--n_resblocks', '2']),
    ('RDN-B', 'RDN', RDN_ARGS),
    ('DDBPN', 'DDBPN', ['--n0', str(DDBPN_N0), '--nr', str(DDBPN_NR),
                        '--depth', '2']),
    ('WDSR-B cs', 'WDSR', ['--n_feats', str(WDSR_C), '--n_resblocks', '2',
                           '--use_pallas', 'cs']),
    ('SRResNet', 'SRResNet', ['--n_resblocks', '2']),
    ('SRCNN', 'SRCNN', []),
    ('EDSR True', 'EDSR', ['--n_resblocks', '2', *TRUE_ARGS]),
    ('RCAN True', 'RCAN', ['--n_resgroups', '2', '--n_resblocks', '2',
                           *TRUE_ARGS]),
    ('WDSR-B True', 'WDSR', ['--n_feats', str(WDSR_C), '--n_resblocks', '2',
                             *TRUE_ARGS]))
EXPORT_LR = 64          # the routes' LR side
# every forward launch counter an eval route can move
FWD_COUNTERS = (trunk_fwd, conv3x3_fwd, CONV5_FWD, K2G_FWD, K2G5_FWD,
                upsample_fwd, rcab_fwd, rdn_fwd, wdsr_fwd, resblock_fused_fwd,
                (resblock_trunk_fwd, 'calls'), ca_layer_fwd,
                wdsr_block_fused_fwd)
ASSETS = ('model_summary.txt', 'source_snapshot.zip', 'model_graph.txt')
KNOB_STEPS = 5          # steps of each deterministic, anomaly, profiled fit
REMAT_STEPS = 3
# the fresh process that loads the exported EDSR programs: it imports
# srtpu_torch.export alone (whose load registers the srtpu:: operators)
# and reads the launch counters from the modules that import brought in
EXPORT_CHILD = r'''
import json, sys
import numpy as np
import torch
from srtpu_torch.export import load
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for name, path, lr_path in json.loads(sys.argv[1]):
    program = load(path).module()
    fns = [(sys.modules['srtpu_torch.ops.' + m], f, 'launches')
           for m, f in (('trunk', 'trunk_fwd'), ('conv', 'conv3x3_fwd'),
                        ('upsample', 'upsample_fwd'))]
    lr = torch.from_numpy(np.load(lr_path)).cuda()
    for mod, f, a in fns:
        setattr(getattr(mod, f), a, 0)
    with torch.inference_mode():
        sr = program(lr)
    torch.cuda.synchronize()
    counts = {f: getattr(getattr(mod, f), a) for mod, f, a in fns}
    np.save(path + '.sr.npy', sr.cpu().numpy())
    times = []
    with torch.inference_mode():
        for i in range(8):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in 'se')
            s.record()
            program(lr)
            e.record()
            e.synchronize()
            if i >= 3:
                times.append(s.elapsed_time(e))
    out[name] = {'counts': counts, 'ms': float(np.median(times))}
print(json.dumps(out))
'''


def _fwd_counts() -> dict:
    return {_counter_name(k): getattr(*_counter(k)) for k in FWD_COUNTERS}


def _zero_fwd() -> None:
    for k in FWD_COUNTERS:
        setattr(*_counter(k), 0)


def _export_edsr(device, smi: str, tmp: Path, ckpts: Path) -> dict:
    """Phase 28 (1): EDSR-baseline x4 from phase 27's checkpoint through
    the export CLI, loaded and run in a fresh process, against the eager
    predict (and tiled predict) step bit for bit; K1-K3 per image (per
    tile batch)."""
    args = cli.build_parser().parse_args(
        ['validate', '--checkpoint', str(ckpts), '--device', 'cuda'])
    model, _, _ = cli._restore(args, device)
    model.eval()
    jobs, eager, want, per = [], {}, {}, {}
    for h, w, tile in ((128, 128, 0), (512, 352, 0), (512, 352, TILE)):
        name = f'{h}x{w}' + (f' --tile {tile}' if tile else '')
        out = tmp / f'edsr_{h}x{w}_{tile}.pt2'
        extra = ['--tile', str(tile), '--tile-overlap',
                 str(TILE_OVERLAP)] if tile else []
        _zero_fwd()
        t0 = time.perf_counter()
        _cli_counted(['export', '--checkpoint', str(ckpts), '--out',
                      str(out), '--size', f'{h}x{w}', '--device', 'cuda',
                      *extra], {}, f'export {name}')
        export_s = time.perf_counter() - t0
        need(not any(_fwd_counts().values()),
             f'export {name} launched a kernel: {_fwd_counts()}')
        lr = torch.from_numpy(np.random.default_rng(SEED + h).random(
            (1, h, w, 3), dtype=np.float32)).to(device)
        np.save(tmp / f'lr_{h}x{w}.npy', lr.cpu().numpy())
        step = (make_tiled_predict_step(model, SCALE, tile, TILE_OVERLAP,
                                        TILE_BATCH) if tile
                else make_predict_step(model))
        want[name] = step(lr).cpu().numpy()
        eager[name] = median_ms(lambda: step(lr), launches=1, windows=5)
        per[name] = (_tile_batches(h, w, tile, TILE_OVERLAP, TILE_BATCH)
                     if tile else 1)
        print(f'phase 28: export EDSR-baseline x4 {name}: '
              f'{out.stat().st_size:,} bytes in {export_s:.3f} s (CLI, '
              f'host clock), no kernel launched while tracing')
        jobs.append((name, str(out), str(tmp / f'lr_{h}x{w}.npy')))
    proc = subprocess.run(
        [sys.executable, '-c', EXPORT_CHILD, json.dumps(jobs)],
        cwd=Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=600)
    need(proc.returncode == 0, f'the export child failed:\n{proc.stderr}')
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    expect = {'trunk_fwd': L, 'conv3x3_fwd': 3, 'upsample_fwd': 1}
    counts = {}
    for name, path, _ in jobs:
        sr = np.load(path + '.sr.npy')
        need(sr.shape == want[name].shape and np.array_equal(sr, want[name]),
             f'exported EDSR {name}: max |d| '
             f'{np.abs(sr - want[name]).max()} against eager predict')
        c = got[name]['counts']
        need(c == {k: v * per[name] for k, v in expect.items()},
             f'exported EDSR {name}: launches {c}, expected {expect} x '
             f'{per[name]}')
        counts[name] = c
        print(f'phase 28: exported EDSR-baseline x4 {name}, loaded in a '
              f'fresh process: equal to eager predict bit for bit; '
              f'launches {c} = K1 1 call ({L} blocks), K2 3, K3 1 per '
              + ('tile batch x ' + str(per[name]) if per[name] > 1
                 else 'image')
              + f'; {got[name]["ms"]:.3f} ms exported against '
              f'{eager[name]:.3f} ms eager per image (CUDA events, median '
              f'of 5)  [{smi}]')
    return {'export_edsr': {trunk_fwd: sum(c['trunk_fwd']
                                           for c in counts.values()),
                            conv3x3_fwd: sum(c['conv3x3_fwd']
                                             for c in counts.values()),
                            upsample_fwd: sum(c['upsample_fwd']
                                              for c in counts.values())}}


def _export_routes(device, smi: str, tmp: Path) -> dict:
    """Phase 28 (2): every other route at 2 blocks or groups, exported,
    saved and loaded, equal to eager predict bit for bit with the same
    launches."""
    from srtpu_torch.export import (export_serving, load, save,
                                    srtpu_ops)
    runs = {}
    for label, model_name, flags in EXPORT_ROUTES:
        args = cli.build_parser().parse_args(
            ['predict', '--model', model_name, *flags, '--seed',
             str(SEED), '--device', 'cuda'])
        model = cli.build_model(args, device).eval()
        path = tmp / f'{model_name}_{len(runs)}.pt2'
        t0 = time.perf_counter()
        save(export_serving(model, 1, EXPORT_LR, EXPORT_LR), path)
        export_s = time.perf_counter() - t0
        program = load(path)
        nodes = srtpu_ops(program)
        lr = torch.rand((1, EXPORT_LR, EXPORT_LR, 3),
                        generator=torch.Generator().manual_seed(SEED)).to(
                            device)
        _zero_fwd()
        want = make_predict_step(model)(lr)
        torch.cuda.synchronize()
        eager = _fwd_counts()
        _zero_fwd()
        with torch.inference_mode():
            got = program.module()(lr)
        torch.cuda.synchronize()
        counts = _fwd_counts()
        need(torch.equal(got, want), f'exported {label}: max |d| '
             f'{(got - want).abs().max().item()} against eager')
        need(counts == eager, f'exported {label}: launches {counts}, '
             f'eager {eager}')
        need(bool(nodes) == any(eager.values()),
             f'exported {label}: nodes {nodes}, eager launches {eager}')
        runs[f'export_{model_name.lower()}_{len(runs)}'] = {
            k: getattr(*_counter(k)) for k in FWD_COUNTERS}
        print(f'phase 28: exported {label} (LR {EXPORT_LR}x{EXPORT_LR}) in '
              f'{export_s:.3f} s: {nodes or "no srtpu:: operator"}; equal '
              f'to eager bit for bit, launches '
              + (', '.join(f'{k} {v}' for k, v in counts.items() if v)
                 or 'none'))
    return runs


def _peak_steps(net, batches, remat: bool):
    """REMAT_STEPS train steps of a copy of ``net`` (with or without
    remat): its final state dict, the peak of allocated memory above
    what was allocated before, and the median step ms of 5 more."""
    m = copy.deepcopy(net)
    st = TrainState(m, build_optimizer('ADAM', ['lr=1e-4'],
                                       m.parameters()))
    step = make_train_step(parse_losses('l1'), remat=remat)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for lr, hr in batches:
        step(st, lr, hr)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    lr, hr = batches[0]
    ms = median_ms(lambda: step(st, lr, hr), launches=1, windows=5)
    return sd, peak, ms


def _remat(device, smi: str, tmp: Path) -> None:
    """Phase 28 (3): 3 steps with and without remat, EDSR-baseline and
    RCAN-10x16 at the bench recipe: parameters bit for bit, peak memory,
    step ms."""
    data = fit_data(tmp / 'remat', SCALE, TRAIN_PATCH)
    batches = fit_batches(data, SCALE, TRAIN_PATCH, device, n=REMAT_STEPS)
    for label, flags in (('EDSR-baseline', []), ('RCAN-10x16', RCAN_ARGS)):
        model = 'RCAN' if flags else 'EDSR'
        net = cli.build_model(cli.build_parser().parse_args(
            ['fit', '--model', model, '--train_datasets', 'Train', *flags,
             '--seed', str(SEED)]), device)
        with _cudnn_deterministic():
            plain_sd, plain_peak, plain_ms = _peak_steps(net, batches, False)
            remat_sd, remat_peak, remat_ms = _peak_steps(net, batches, True)
        need(all(torch.equal(plain_sd[k], remat_sd[k]) for k in plain_sd),
             f'{label}: remat parameters differ from the plain step\'s')
        print(f'phase 28: {label} x4 remat, {REMAT_STEPS} steps (batch '
              f'{TRAIN_BATCH}, LR 32x32): parameters equal bit for bit; '
              f'peak memory above the state {plain_peak / 2 ** 20:.1f} MiB '
              f'-> {remat_peak / 2 ** 20:.1f} MiB with remat; step '
              f'{plain_ms:.3f} -> {remat_ms:.3f} ms (CUDA events, median '
              f'of 5)  [{smi}]')


def _fit_argv(data: Path, run: Path, steps: int, *extra) -> list:
    return ['fit', '--model', 'EDSR', '--scale_factor', str(SCALE),
            '--datasets_dir', str(data), '--train_datasets', 'Train',
            '--batch_size', str(TRAIN_BATCH), '--patch_size',
            str(TRAIN_PATCH), '--optimizer_params', 'lr=1e-4',
            '--max_epochs', str(steps), '--device', 'cuda', '--seed',
            str(SEED), '--default_root_dir', str(run), *extra]


def _flags() -> tuple:
    cudnn = torch.backends.cudnn
    return (torch.are_deterministic_algorithms_enabled(),
            cudnn.deterministic, cudnn.benchmark)


def _deterministic(device, smi: str, tmp: Path) -> None:
    """Phase 28 (4): two deterministic 5-step fits each of EDSR-baseline
    and SRGAN 'cs' equal bit for bit; the flags back after; the
    deterministic step's ms."""
    data = fit_data(tmp / 'det', SCALE, TRAIN_PATCH)
    before = _flags()
    for label in ('EDSR-baseline', 'SRGAN cs'):
        weights = []
        for i in range(2):
            run = tmp / 'det' / f'{label[:4]}{i}'
            argv = (_gan_argv(data, run) + ['--max_epochs', str(KNOB_STEPS)]
                    if label.startswith('SRGAN')
                    else _fit_argv(data, run, KNOB_STEPS))
            _cli_counted(argv + ['--deterministic', 'true'], {},
                         f'{label} deterministic fit')
            need(_flags() == before, f'{label}: deterministic flags '
                 f'{_flags()} left set, before {before}')
            weights.append(torch.load(run / 'final_weights.pt',
                                      weights_only=True))
        need(all(torch.equal(weights[0][k], weights[1][k])
                 for k in weights[0]),
             f'{label}: two deterministic fits differ')
        print(f'phase 28: {label} x4, two --deterministic fits of '
              f'{KNOB_STEPS} steps: final weights equal bit for bit; '
              f'torch.are_deterministic_algorithms_enabled, '
              f'cudnn.deterministic, cudnn.benchmark back to {before}')
    net = cli.build_model(cli.build_parser().parse_args(
        _fit_argv(data, tmp, 1)), device)
    lr, hr = fit_batches(data, SCALE, TRAIN_PATCH, device, n=1)[0]
    ms = {}
    for det in (False, True):
        m = copy.deepcopy(net)
        st = TrainState(m, build_optimizer('ADAM', ['lr=1e-4'],
                                           m.parameters()))
        step = make_train_step(parse_losses('l1'))
        prev = train_loop.set_deterministic(device) if det else None
        try:
            ms[det] = median_ms(lambda: step(st, lr, hr), launches=1,
                                windows=5)
        finally:
            train_loop.restore_deterministic(prev)
    print(f'phase 28: EDSR-baseline x4 train step {ms[False]:.3f} ms, '
          f'deterministic {ms[True]:.3f} ms (CUDA events, median of 5)  '
          f'[{smi}]')


def _step_ms_fit(argv, what: str) -> list:
    """``cli.main(argv)`` with each train step's ms (CUDA events) kept."""
    times = []
    real = train_loop.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(state, lr, hr):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in 'se')
            s.record()
            logs = step(state, lr, hr)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
            return logs
        return timed
    train_loop.make_train_step = make
    try:
        _cli_counted(argv, {}, what)
    finally:
        train_loop.make_train_step = real
    return times


def _anomaly_profiler(device, smi: str, tmp: Path) -> dict:
    """Phase 28 (5) and (6): a fit with a NaN weight under detect_anomaly
    raises FloatingPointError; the fit without the knob, its step ms; a
    fit with profiler_dir writes a trace naming the srtpu:: operators and
    the kernels."""
    data = fit_data(tmp / 'knobs', SCALE, TRAIN_PATCH)
    argv = _fit_argv(data, tmp / 'nan', KNOB_STEPS)
    model = cli.build_model(cli.build_parser().parse_args(argv), device)
    with torch.no_grad():
        model.head.weight[0, 0, 0, 0] = float('nan')
    dm = SRData(datasets_dir=str(data), train_datasets=['Train'],
                batch_size=TRAIN_BATCH, patch_size=TRAIN_PATCH,
                scale_factor=SCALE, seed=SEED)
    trainer = Trainer(TrainerConfig(default_root_dir=str(tmp / 'nan'),
                                    max_epochs=KNOB_STEPS,
                                    detect_anomaly=True))
    try:
        trainer.fit(model, dm, optimizer_params=['lr=1e-4'])
    except FloatingPointError as e:
        print(f'phase 28: detect_anomaly, a NaN weight in head.weight: '
              f'FloatingPointError: {e}')
    else:
        need(False, 'detect_anomaly: the NaN fit did not raise')
    finally:
        trainer.close()
    times = _step_ms_fit(_fit_argv(data, tmp / 'plain', KNOB_STEPS),
                         'the fit without detect_anomaly')
    print(f'phase 28: EDSR-baseline x4 fit without detect_anomaly: steps '
          + ' '.join(f'{t:.3f}' for t in times) + ' ms (CUDA events; '
          f'phase 4: {PHASE4_STEP_MS.get("EDSR", float("nan")):.3f} ms)  '
          f'[{smi}]')
    prof = tmp / 'prof'
    counts, _, _ = _cli_counted(
        _fit_argv(data, tmp / 'profiled', 2, '--profiler_dir', str(prof)),
        STEP_LAUNCHES, 'the profiled fit')
    _need_counts(counts, STEP_LAUNCHES, 2, 'the profiled fit')
    traces = sorted(prof.glob('*.pt.trace.json'))
    need(len(traces) == 1, f'profiler_dir holds {traces}')
    text = traces[0].read_text()
    names = ('srtpu::trunk_fwd', 'srtpu::conv_fwd', 'srtpu::upsample_fwd',
             'conv_sm90_kernel', 'wgrad_sm90_kernel')
    missing = [n for n in names if n not in text]
    need(not missing, f'the profiler trace lacks {missing}')
    print(f'phase 28: profiler_dir: {traces[0].name} '
          f'({len(text) / 2 ** 20:.1f} MiB) names ' + ', '.join(names))
    return {'profiled_fit': counts}


def check_records(root: Path, assets_s: list, smi: str) -> None:
    """Phase 28 (7): the event file of phase 27's fit reads back (CRCs,
    scalars, images, histograms) and the three run assets exist."""
    from srtpu_torch.utils.tensorboard import read_events
    files = sorted((root / 'tensorboard_logs').glob('events.out.tfevents.*'))
    need(len(files) == 1, f'tensorboard_logs holds {files}')
    events = read_events(files[0])
    need(events[0]['file_version'] == 'brain.Event:2',
         'the event file has no version record first')
    kinds = {'simple_value': 0, 'image': 0, 'histo': 0}
    for ev in events[1:]:
        for v in ev['values']:
            for k in kinds:
                kinds[k] += k in v
    tags = {v['tag'] for ev in events for v in ev['values']}
    need(all(kinds.values()) and 'Val/PSNR' in tags
         and any(t.startswith('weights/') for t in tags),
         f'the event file holds {kinds}')
    for name in ASSETS:
        need((root / name).is_file() and (root / name).stat().st_size > 0,
             f'run asset {name} missing')
    print(f'phase 28: TensorBoard: {files[0].name}, {len(events)} records, '
          f'CRCs good: {kinds["simple_value"]} scalars, {kinds["image"]} '
          f'images, {kinds["histo"]} histograms; run assets '
          + ', '.join(f'{n} {(root / n).stat().st_size:,} B' for n in ASSETS)
          + '; written in ' + ', '.join(f'{s:.3f}' for s in assets_s)
          + f' s a fit (host clock)  [{smi}]')


def _operator_host_cost(device, smi: str) -> None:
    """Phase 28: the host time an ``srtpu::`` operator adds to a launch:
    ``conv3x3_fwd`` (the operator) against its CUDA implementation called
    directly (the ctypes launch alone), and ``trunk_fwd`` the same way, at
    the predict shape (host clock, median of 51 calls, the device idle
    before each)."""
    from srtpu_torch.ops.conv import conv_fwd_cuda
    from srtpu_torch.ops.trunk import trunk_fwd_cuda
    gen = torch.Generator().manual_seed(SEED)
    x = _uniform(gen, (1, 128, 128, C), 1.0, device, torch.bfloat16)
    w = _uniform(gen, (3, 3, C, C), 0.05, device, torch.bfloat16)
    b = _uniform(gen, (C,), 0.05, device, torch.float32)
    ws, bs = w.expand(L, *w.shape).contiguous(), b.expand(L, C).contiguous()
    pairs = (('conv3x3_fwd', lambda: conv3x3_fwd(x, w, b),
              lambda: conv_fwd_cuda(x, w, b, False)),
             ('trunk_fwd', lambda: trunk_fwd(x, ws, bs, ws, bs, 1.0),
              lambda: trunk_fwd_cuda(x, ws, bs, ws, bs, 1.0, False)))
    for name, op, direct in pairs:
        t_op, t_direct = host_ms(op, calls=51), host_ms(direct, calls=51)
        print(f'phase 28: host time of {name} through srtpu::: '
              f'{t_op * 1e3:.1f} us, its ctypes launch called directly '
              f'{t_direct * 1e3:.1f} us: the operator adds '
              f'{(t_op - t_direct) * 1e3:.1f} us a call  [{smi}]')


def run_phase28(device, smi: str, tmp: Path, ckpts: Path,
                assets_s: list) -> dict:
    """Phase 28 on phase 27's run (the module note). Returns the launch
    counts of its main-path runs."""
    t0 = time.perf_counter()
    _operator_host_cost(device, smi)
    runs = _export_edsr(device, smi, tmp, ckpts)
    runs.update(_export_routes(device, smi, tmp))
    _remat(device, smi, tmp)
    _deterministic(device, smi, tmp)
    runs.update(_anomaly_profiler(device, smi, tmp))
    check_records(tmp / 'a', assets_s, smi)
    print(f'phase 28 took {time.perf_counter() - t0:.1f} s')
    return runs


# ----------------------------------------------------------- phase 29

# Phase 29: srtpu's other losses and metrics on EDSR-baseline x4 at the
# bench recipe. Each DSL: a short fit through the CLI's function
# (P29_STEPS steps, one an epoch), its held step against the CPU, its
# step time and peak memory. No kernel of the port computes a loss or a
# metric (srtpu leaves them to XLA); K1-K3 and W run the model each way.
P29_DSLS = ('0.5 * l1 + 0.5 * adaptive', 'flip', 'haarpsi', 'pieapp',
            'lpips', 'dists', '0.5 * l1 + 0.5 * edge_loss',
            '0.5 * l1 + 0.5 * pencil_sketch', 'edge_loss')
P29_STEPS = 8
# no term carries a gradient: the loss need not fall
P29_NO_GRAD = {'edge_loss'}
# The card's loss against the CPU's on the card's SR and HR: the same f32
# arithmetic (every loss's convolutions in full f32, imgops.conv2d_f32),
# the sums reduced in another order: the value within 1e-5 relative
# (edge_loss: 1e-4 absolute, its Canny decisions), the SR gradient within
# 2^-6 of its largest magnitude, as the kernels' gradients elsewhere.
P29_VALUE_RTOL, P29_EDGE_ATOL = 1e-5, 1e-4
P29_GRAD_TOL = 2.0 ** -6
# PieAPP's max pools send the gradient to the larger of the window's four
# values. Where two are nearly equal, the card's f32 convs (another sum
# order) and the CPU's may rank them apart, and the gradient goes to
# another pixel (ROADMAP.md queue 3, F19). So PieAPP's pool decisions
# on the card are counted against the CPU's, each differing decision
# must be a near tie (the CPU's two values within 2^-10 relative), and
# the card's gradient with the CPU's decisions forced is held to 2^-6;
# the gradient on the card's own decisions is held to 2^-6 where no
# decision differs, and printed beside.
P29_MAXPOOL = {'pieapp'}
P29_NEAR_TIE = 2.0 ** -10
# (b): the metrics card vs CPU: BRISQUE's score 1e-3 relative and its
# shape parameters one table step, FLIP 1e-5, LPIPS 1e-5 relative (its
# VGG16 in full f32), the others as phase 25
P29_METRICS = ('BRISQUE', 'FLIP', 'LPIPS', 'MS-SSIM', 'PSNR', 'SSIM')
P29_METRIC_TOL = {'BRISQUE': ('rel', 1e-3), 'FLIP': ('abs', 1e-5),
                  'LPIPS': ('rel', 1e-5), 'MS-SSIM': ('abs', 1e-5),
                  'PSNR': ('abs', 1e-4), 'SSIM': ('abs', 1e-5)}
P29_HR_SIZES = VAL_HR_SIZES[:2]


def _p29_state(net, comp) -> TrainState:
    return TrainState.create(copy.deepcopy(net), comp, 'ADAM', ['lr=1e-4'])


def _loss_grad(comp, sr, hr, lp):
    """(the composite's value, its gradient with respect to ``sr``)."""
    x = sr.detach().clone().requires_grad_()
    total, _ = comp(x, hr) if lp is None else comp(x, hr, lp)
    if total.requires_grad:
        total.backward()
    grad = x.grad if x.grad is not None else torch.zeros_like(x)
    return float(total.detach()), grad.float().cpu()


def _pieapp_pools(comp, sr, hr, g_cpu, scale):
    """PieAPP's max-pool decisions on the card against the CPU's, on the
    card's SR and HR: (windows, differing decisions, the largest gap
    between the CPU's two values at a differing window relative to the
    larger, the card's value and its SR gradient's error with the CPU's
    decisions forced)."""
    from srtpu_torch.losses import pieapp as pieapp_mod

    def recorded(store):
        def pool(h):
            out, idx = F.max_pool2d(h, 2, return_indices=True)
            store.append((h.detach(), idx))
            return out
        return pool

    def forced(idxs):
        it = iter(idxs)

        def pool(h):
            idx = next(it).to(h.device)
            return h.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        return pool

    cpu_rec, card_rec = [], []
    with mock.patch.object(pieapp_mod, '_pool', recorded(cpu_rec)):
        _loss_grad(comp, sr.cpu(), hr.cpu(), None)
    with mock.patch.object(pieapp_mod, '_pool', recorded(card_rec)):
        _loss_grad(comp, sr, hr, None)
    windows, flips, worst = 0, 0, 0.0
    for (h, i_cpu), (_, i_card) in zip(cpu_rec, card_rec, strict=True):
        i_card = i_card.cpu()
        windows += i_cpu.numel()
        diff = (i_cpu != i_card).flatten()
        flips += int(diff.sum())
        if diff.any():
            hf = h.flatten(2)
            a = hf.gather(2, i_cpu.flatten(2)).flatten()[diff]
            b = hf.gather(2, i_card.flatten(2)).flatten()[diff]
            worst = max(worst, float(((a - b).abs() / a.abs().clamp_min(
                1e-30)).max()))
    with mock.patch.object(pieapp_mod, '_pool',
                           forced([i for _, i in cpu_rec])):
        v_forced, g_forced = _loss_grad(comp, sr, hr, None)
    return (windows, flips, worst, v_forced,
            float((g_forced - g_cpu).abs().max()) / scale)


def _p29_held(dsl: str, comp, net, lr, hr, device, smi: str) -> None:
    """The DSL's loss and SR gradient on the card against the CPU's, on
    the card's SR of one held batch (the kernel path's forward) and its
    HR; PieAPP's pool decisions against the CPU's (``_pieapp_pools``)."""
    with torch.no_grad():
        sr = net(lr).float()
    hr = hr.float()
    lp = loss_parameters(comp, device)
    lp_cpu = loss_parameters(comp, 'cpu')
    name = dsl.split('*')[-1].strip()
    v_cpu, g_cpu = _loss_grad(comp, sr.cpu(), hr.cpu(), lp_cpu)
    v, g = _loss_grad(comp, sr, hr, lp)
    scale = max(float(g_cpu.abs().max()), 1e-30)
    g_err = float((g - g_cpu).abs().max()) / scale
    g_l2 = float((g - g_cpu).norm() / max(float(g_cpu.norm()), 1e-30))
    if name == 'edge_loss':
        err, tol, kind = abs(v - v_cpu), P29_EDGE_ATOL, 'abs'
    else:
        err, tol, kind = abs(v - v_cpu) / abs(v_cpu), P29_VALUE_RTOL, 'rel'
    extra, g_ok = '', g_err <= P29_GRAD_TOL
    if name in P29_MAXPOOL:
        windows, flips, worst, v_f, g_f = _pieapp_pools(comp, sr, hr, g_cpu,
                                                        scale)
        rel_f = abs(v_f - v_cpu) / abs(v_cpu)
        extra = (f'; max-pool decisions: {flips} of {windows} windows '
                 f'differ from the CPU\'s, each a near tie (the CPU\'s two '
                 f'values at most {worst:.3g} apart relative, tol '
                 f'{P29_NEAR_TIE:.3g}); with the CPU\'s decisions forced: '
                 f'value rel {rel_f:.3g}, SR grad {g_f:.3g} (tol '
                 f'{P29_GRAD_TOL:.3g})')
        need(worst <= P29_NEAR_TIE, f'{dsl}: a max-pool decision that '
             f'differs from the CPU\'s is no near tie ({worst})')
        need(rel_f <= P29_VALUE_RTOL and g_f <= P29_GRAD_TOL,
             f'{dsl}: card with the CPU\'s pool decisions vs CPU')
        # the card's own decisions: the gradient is excused from 2^-6
        # only by decisions that differ
        g_ok = g_ok or flips > 0
    print(f'phase 29: {dsl!r} held batch, card vs CPU on the card\'s SR: '
          f'value {v:.7g} / {v_cpu:.7g} ({kind} {err:.3g}, tol {tol:.3g}); '
          f'SR grad {g_err:.3g} of its largest {scale:.3g}, L2 {g_l2:.3g} '
          f'(tol {P29_GRAD_TOL:.3g}){extra}  [{smi}]')
    need(np.isfinite(v) and err <= tol, f'{dsl}: card vs CPU value')
    need(bool(torch.isfinite(g).all()) and g_ok,
         f'{dsl}: card vs CPU SR gradient')


def _p29_fits(device, smi: str, tmp: Path) -> dict:
    """(a): each DSL's CLI fit, held step, step time and peak memory."""
    data = fit_data(tmp, SCALE, TRAIN_PATCH)
    base = ['fit', '--model', 'EDSR', '--scale_factor', str(SCALE),
            '--n_feats', str(C), '--n_resblocks', str(L), '--datasets_dir',
            str(data), '--train_datasets', 'Train', '--batch_size',
            str(TRAIN_BATCH), '--patch_size', str(TRAIN_PATCH),
            '--optimizer', 'ADAM', '--optimizer_params', 'lr=1e-4',
            '--max_epochs', str(P29_STEPS), '--precision', 'bf16',
            '--device', 'cuda', '--seed', str(SEED)]
    runs = {}
    net = cli.build_model(cli.build_parser().parse_args(
        base + ['--losses', 'l1', '--default_root_dir', str(tmp / 'n')]),
        device)
    lr, hr = fit_batches(data, SCALE, TRAIN_PATCH, device, n=1)[0]
    l1 = parse_losses('l1')
    st = _p29_state(net, l1)
    step = make_train_step(l1)
    ms_l1 = median_ms(lambda: step(st, lr, hr), launches=5, windows=3)
    del st
    print(f'phase 29: l1 train step {ms_l1:.3f} ms (CUDA events, median of '
          f'3 windows of 5 steps; batch {TRAIN_BATCH}, LR 32x32 -> HR '
          f'128x128, Adam; cuDNN TF32 on, PyTorch\'s default; the losses\' '
          f'convolutions in full f32)  [{smi}]')
    for i, dsl in enumerate(P29_DSLS):
        t0 = time.perf_counter()
        log = _LossLog()
        logging.getLogger('srtpu_torch.train.loop').addHandler(log)
        # without a gradient the step runs no backward: the forward
        # kernels alone
        expected = {k: v if dsl not in P29_NO_GRAD or k in
                    EXPECTED_LAUNCHES else 0
                    for k, v in STEP_LAUNCHES.items()}
        try:
            counts, wall, _ = _cli_counted(
                base + ['--losses', dsl, '--default_root_dir',
                        str(tmp / f'r{i}')], expected,
                f'fit --losses {dsl!r}')
        finally:
            logging.getLogger('srtpu_torch.train.loop').removeHandler(log)
        _need_counts(counts, expected, P29_STEPS, f'fit --losses {dsl!r}')
        runs[f'p29_fit_{i}'] = counts
        losses = log.losses
        need(len(losses) == P29_STEPS and all(map(np.isfinite, losses)),
             f'{dsl}: fit losses {losses}')
        first, last = np.mean(losses[:3]), np.mean(losses[-3:])
        if dsl not in P29_NO_GRAD:
            need(last < first, f'{dsl}: the fit loss did not fall')
        comp = parse_losses(dsl)
        _p29_held(dsl, comp, net, lr, hr, device, smi)
        st = _p29_state(net, comp)
        step = make_train_step(comp)
        step(st, lr, hr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step(st, lr, hr)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
        ms = median_ms(lambda: step(st, lr, hr), launches=5, windows=3)
        _profile(lambda: step(st, lr, hr), ms, smi, EDSR_PROFILE,
                 f'phase 29: {dsl!r} train step', top=4)
        del st, comp
        print(f'phase 29: fit --losses {dsl!r}: {P29_STEPS} steps in '
              f'{wall:.3f} s (CLI, incl. model and loss init); losses '
              + ' '.join(f'{v:.5f}' for v in losses)
              + '; launches ' + ', '.join(
                  f'{_counter_name(k)} {counts[k]}' for k in expected)
              + f' = per step x {P29_STEPS}; train step {ms:.3f} ms against '
              f'l1\'s {ms_l1:.3f} ({ms / ms_l1:.2f}x); step peak '
              f'{peak:.1f} MiB above the state; {time.perf_counter() - t0:.1f}'
              f' s with the checks  [{smi}]')
    return runs


def _p29_validate(device, smi: str, tmp: Path) -> dict:
    """(b): validate with srtpu's six metrics, card vs CPU per image,
    BRISQUE on the true shape."""
    data = val_data(tmp, P29_HR_SIZES)
    argv = ['validate', '--model', 'EDSR', '--scale_factor', str(SCALE),
            '--n_feats', str(C), '--n_resblocks', str(L), '--datasets_dir',
            str(data), '--eval_datasets', 'Val', '--metrics', *P29_METRICS,
            '--precision', 'bf16', '--device', 'cuda', '--seed', str(SEED),
            '--default_root_dir', str(tmp / 'vout')]
    n = len(P29_HR_SIZES)
    counts, wall, out = _cli_counted(argv, EXPECTED_LAUNCHES,
                                     'validate (phase 29)')
    _need_counts(counts, EXPECTED_LAUNCHES, n, 'validate (phase 29)')
    printed = dict(ln.split(': ') for ln in out.strip().splitlines())
    need(list(printed) == sorted(f'Val/{m}' for m in P29_METRICS),
         f'validate printed {list(printed)}')
    print(f'phase 29: validate CLI --metrics {" ".join(P29_METRICS)}: {n} '
          f'images in {wall:.3f} s; ' + ', '.join(
              f'{k} {v}' for k, v in printed.items()) + f'  [{smi}]')
    net = cli.build_model(cli.build_parser().parse_args(argv),
                          device).eval()
    fns = build_metrics(P29_METRICS)
    eval_step = make_eval_step(net, fns)
    dm = SRData(datasets_dir=str(data), eval_datasets=['Val'],
                scale_factor=SCALE)
    dm.setup('validate')
    exact = []
    for batch in dm.eval_loaders()[0]:
        lr, hr, mask = (torch.from_numpy(a).to(device)
                        for a in (batch.lr, batch.hr, batch.mask))
        hs, ws = batch.hr_size
        tag = f'phase 29: validate {batch.names[0]} (HR {hs}x{ws})'
        sr, res = eval_step(lr, hr, mask)
        res = {k: float(v) for k, v in res.items()}
        padded = res['BRISQUE']
        crop = sr[:, :hs, :ws]
        res['BRISQUE'] = brisque_exact(crop)
        exact.append(res['BRISQUE'])
        hr32 = hr.float().clamp(0, 1)
        with torch.inference_mode():
            cpu = {k: float(fn(sr.cpu()) if k == 'BRISQUE' else
                            fn(sr.cpu(), hr32.cpu(), mask=mask.cpu()))
                   for k, fn in fns.items()}
        cpu['BRISQUE'] = brisque_exact(crop.cpu())
        f_card = brisque_features(crop.float())
        f_cpu = brisque_features(crop.float().cpu())
        shape_cols = [0, 2, 6, 10, 14, 18, 20, 24, 28, 32]
        d_shape = float((f_card.cpu() - f_cpu)[:, shape_cols].abs().max())
        errs = {}
        for k, (kind, tol) in P29_METRIC_TOL.items():
            d = abs(res[k] - cpu[k])
            errs[k] = d / abs(cpu[k]) if kind == 'rel' else d
            need(np.isfinite(res[k]) and errs[k] <= tol,
                 f'{tag}: {k} card {res[k]} vs CPU {cpu[k]}')
        need(d_shape <= 1e-3 + 1e-6, f'{tag}: BRISQUE shape parameters '
             f'{d_shape} apart')
        with torch.inference_mode():
            per = {'BRISQUE': median_ms(lambda: brisque_exact(crop),
                                        launches=1),
                   'FLIP': median_ms(lambda: fns['FLIP'](sr, hr32,
                                                         mask=mask),
                                     launches=1),
                   'LPIPS': median_ms(lambda: fns['LPIPS'](sr, hr32,
                                                           mask=mask),
                                      launches=1),
                   'forward': median_ms(lambda: net(lr), launches=1)}
        print(f'{tag}: card ' + ' '.join(
            f'{k} {res[k]:.6g}' for k in P29_METRICS) + ' | |card - CPU| '
            + ' '.join(f'{k} {errs[k]:.3g} ({P29_METRIC_TOL[k][0]}, tol '
                       f'{P29_METRIC_TOL[k][1]:.3g})' for k in P29_METRICS)
            + f'; BRISQUE shape parameters {d_shape:.3g} apart (a table '
            f'step 0.001); BRISQUE on the padded bucket {padded:.6g}, on '
            f'the true shape {res["BRISQUE"]:.6g} | ms an image (CUDA '
            'events, median of 5): ' + ', '.join(
                f'{k} {v:.3f}' for k, v in per.items()) + f'  [{smi}]')
    mean = float(np.mean(exact))
    need(abs(float(printed['Val/BRISQUE']) - mean) <= 1e-4 * abs(mean),
         f'printed Val/BRISQUE {printed["Val/BRISQUE"]} is not the '
         f'true-shape mean {mean}')
    return {'p29_validate': counts}


def _p29_fit_val(device, smi: str, tmp: Path) -> dict:
    """(c): a fit with val and edge_loss in the DSL writes srtpu's
    ``_edges`` PNGs."""
    data = fit_data(tmp / 'c', SCALE, TRAIN_PATCH)
    val_data(tmp / 'c', P29_HR_SIZES)
    argv = ['fit', '--model', 'EDSR', '--scale_factor', str(SCALE),
            '--n_feats', str(C), '--n_resblocks', str(L), '--datasets_dir',
            str(data), '--train_datasets', 'Train', '--eval_datasets', 'Val',
            '--batch_size', str(TRAIN_BATCH), '--patch_size',
            str(TRAIN_PATCH), '--losses', '0.5 * l1 + 0.5 * edge_loss',
            '--optimizer', 'ADAM', '--optimizer_params', 'lr=1e-4',
            '--max_epochs', '2', '--check_val_every_n_epoch', '2',
            '--precision', 'bf16', '--device', 'cuda', '--seed', str(SEED),
            '--default_root_dir', str(tmp / 'c' / 'run')]
    images = len(P29_HR_SIZES) * 2      # the sanity pass, the val pass
    expected = {k: v * 2 + EXPECTED_LAUNCHES.get(k, 0) * images
                for k, v in STEP_LAUNCHES.items()}
    counts, wall, _ = _cli_counted(argv, expected, 'fit with edge_loss val')
    _need_counts(counts, expected, 1, 'fit with edge_loss and val')
    want = {'', '_center', '_edges', '_center_edges', '_hr_edges',
            '_hr_center_edges'}
    for h, w in P29_HR_SIZES:
        d = tmp / 'c' / 'run' / 'Val' / f'img{h}x{w}'
        got = {p.name[len('epoch_00002'):-len('.png')]
               for p in d.glob('epoch_00002*.png')}
        need(got == want, f'{d.name}: val images {sorted(got)}')
        sizes = {s: png_size(d / f'epoch_00002{s}.png') for s in want}
        need(sizes['_edges'] == sizes[''] == (h, w)
             and sizes['_center_edges'] == (96, 96),
             f'{d.name}: PNG sizes {sizes}')
    print(f'phase 29: fit --losses "0.5 * l1 + 0.5 * edge_loss" with val '
          f'(2 steps, sanity + 1 val pass on HR 512x512 and 1000x680): '
          f'{wall:.3f} s; each image\'s SR, centre crop, _edges, '
          '_center_edges, _hr_edges, _hr_center_edges PNGs; launches '
          + ', '.join(f'{_counter_name(k)} {counts[k]}' for k in expected)
          + f' = per step x 2 + per eval image x {images}  [{smi}]')
    return {'p29_fit_val': counts}


def run_phase29(device, smi: str) -> dict:
    """Phase 29 (the module note), under PyTorch's TF32 default for
    cuDNN (the losses' and metrics' convolutions run in full f32 all the
    same). Returns the launch counts of its main-path runs."""
    t0 = time.perf_counter()
    with cudnn_tf32(True), tempfile.TemporaryDirectory(
            prefix='srtpu_smoke_p29_') as tmp:
        tmp = Path(tmp)
        runs = _p29_fits(device, smi, tmp / 'a')
        runs.update(_p29_validate(device, smi, tmp / 'b'))
        runs.update(_p29_fit_val(device, smi, tmp))
    print(f'phase 29 took {time.perf_counter() - t0:.1f} s')
    return runs


# ----------------------------------------------------------- phase 30

P30_K = 4                   # steps_per_execution of (a), (c) and (d)
P30_BATCHES = 10            # batches an epoch: 2 windows of 4, 2 alone
P30_EPOCHS = 2              # 20 steps
P30_ACC, P30_ACC_EPOCHS = 3, 3     # the accumulating pair: 30 steps
P30_ROUTE_K = 2             # (b): 2 windows of 2 steps a route
P30_DEPTH = 2               # (b)'s blocks or groups
P30_OPTS = ('RMSprop', 'Ranger', 'RangerVA', 'RangerQH')
P30_OPT_PARAMS = ['lr=1e-4']
# (c): the first update on the card against the CPU's on the same
# gradients, of its largest magnitude: the same f32 formulas, summed and
# rounded in another order (the centralisation's means over up to 576
# values, pow), and the card's rsqrt within 2 ulps
P30_OPT_TOL = 1e-5
# (b): route -> (model, its keyword arguments at full width)
P30_ROUTES = {
    'RCAN cs': ('RCAN', dict(n_feats=C, n_resgroups=P30_DEPTH,
                             n_resblocks=P30_DEPTH, reduction=REDUCTION,
                             use_pallas='cs')),
    'SRResNet': ('SRResNet', dict(n_feats=C, n_resblocks=P30_DEPTH)),
    # RDN has no depth knob: config B's 16 blocks
    'RDN-B': ('RDN', dict(rdn_config='B', growth0=RDN_G0)),
    'DDBPN': ('DDBPN', dict(n0=DDBPN_N0, nr=DDBPN_NR, depth=P30_DEPTH)),
    'WDSR-B cs': ('WDSR', dict(n_feats=WDSR_C, n_resblocks=P30_DEPTH,
                               use_pallas='cs')),
    'EDSR True': ('EDSR', dict(n_feats=C, n_resblocks=P30_DEPTH,
                               use_pallas=True)),
    'RCAN True': ('RCAN', dict(n_feats=C, n_resgroups=P30_DEPTH,
                               n_resblocks=P30_DEPTH, reduction=REDUCTION,
                               use_pallas=True)),
    'WDSR-B True': ('WDSR', dict(n_feats=WDSR_C, n_resblocks=P30_DEPTH,
                                 use_pallas=True)),
    'SRCNN': ('SRCNN', {}),
}
# (d): model -> its keyword arguments at full width and depth
P30_TIMED = {'EDSR': dict(n_feats=C, n_resblocks=L),
             'SRResNet': dict(n_feats=C, n_resblocks=L),
             'DDBPN': dict(n0=DDBPN_N0, nr=DDBPN_NR, depth=DDBPN_DEPTH),
             'WDSR': dict(n_feats=WDSR_C, n_resblocks=WDSR_L,
                          use_pallas='cs')}
P30_TIMED_ARGS = {'EDSR': ['--n_feats', str(C), '--n_resblocks', str(L)],
                  'SRResNet': ['--n_feats', str(C), '--n_resblocks', str(L)],
                  'DDBPN': DDBPN_ARGS, 'WDSR': WDSR_ARGS}


class _GraphLog(logging.Handler):
    """The fit's ``steps_per_execution`` line: (windows, captures,
    replays, eager windows)."""

    def __init__(self):
        super().__init__()
        self.counts = None

    def emit(self, record):
        if record.msg.startswith('steps_per_execution %d'):
            self.counts = tuple(record.args[1:])


def _p30_argv(data: Path, root: Path, model: str = 'EDSR',
              extra=()) -> list:
    args = P30_TIMED_ARGS[model] if model != 'EDSR' else \
        ['--n_feats', str(C), '--n_resblocks', str(L)]
    return ['fit', '--model', model, '--scale_factor', str(SCALE), *args,
            '--datasets_dir', str(data), '--train_datasets', 'Train',
            '--batch_size', str(TRAIN_BATCH), '--patch_size',
            str(TRAIN_PATCH), '--losses', 'l1', '--optimizer', 'ADAM',
            '--optimizer_params', 'lr=1e-4', '--max_epochs',
            str(P30_EPOCHS), '--num_sanity_val_steps', '0', '--precision',
            'bf16', '--device', 'cuda', '--seed', str(SEED),
            '--default_root_dir', str(root), *extra]


def _p30_fit(argv, expected: dict, steps: int, what: str,
             spy: bool = True) -> dict:
    """One fit through the CLI's function with the counters of
    ``expected`` at 0 before it: its counts (held to ``expected`` per
    step x ``steps``), wall seconds, the graph line and the final
    weights. With ``spy`` (a fit held to another bit for bit) also the
    loss at each progress check (``{global step: loss}``, read there),
    and cuDNN's deterministic algorithms: the stock head and tail convs'
    weight grads otherwise sum in an order that changes from run to
    run."""
    losses = {}
    real = train_loop.Trainer._step_progress

    def progress(self, i, n_batches, items, t0, logs, keys):
        losses[self.global_step] = float(logs['loss'])
        return real(self, i, n_batches, items, t0, logs, keys)

    log = _GraphLog()
    logger = logging.getLogger('srtpu_torch.train.loop')
    logger.addHandler(log)
    try:
        with contextlib.ExitStack() as held:
            if spy:
                held.enter_context(mock.patch.object(
                    train_loop.Trainer, '_step_progress', progress))
                held.enter_context(_cudnn_deterministic())
            counts, wall, _ = _cli_counted(argv, expected, what)
    finally:
        logger.removeHandler(log)
    _need_counts(counts, expected, steps, what)
    root = Path(argv[argv.index('--default_root_dir') + 1])
    weights = torch.load(root / 'final_weights.pt', weights_only=True)
    return dict(counts=counts, wall=wall, losses=losses, graphs=log.counts,
                weights=weights)


def _same_weights(a: dict, b: dict, what: str) -> None:
    need(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
         f'{what}: the weights are not equal bit for bit (e.g. '
         f'{[k for k in a if not torch.equal(a[k], b.get(k))][:3]})')


def _p30_windows(graph: dict, ref: dict, what: str) -> list:
    """Each window's last loss of ``graph`` against the same step's loss
    of the one-step fit ``ref``, bit for bit."""
    steps = sorted(graph['losses'])
    need(steps and all(graph['losses'][s] == ref['losses'][s]
                       for s in steps),
         f'{what}: window losses {graph["losses"]} against the single '
         f'steps\' {[ref["losses"].get(s) for s in steps]}')
    return steps


def _p30_cli(device, smi: str, tmp: Path) -> dict:
    """(a): EDSR-baseline x4 through the CLI at k = 4 against k = 1."""
    data = fit_data(tmp, SCALE, TRAIN_PATCH, n=TRAIN_BATCH * P30_BATCHES)
    steps = P30_BATCHES * P30_EPOCHS
    k4 = ['--steps_per_execution', str(P30_K)]
    runs = {}
    ref = _p30_fit(_p30_argv(data, tmp / 'k1'), STEP_LAUNCHES, steps,
                   'fit k 1 (phase 30)')
    got = _p30_fit(_p30_argv(data, tmp / 'k4', extra=k4), STEP_LAUNCHES,
                   steps, 'fit k 4 (phase 30)')
    runs['p30_fit_k1'], runs['p30_fit_k4'] = ref['counts'], got['counts']
    _same_weights(got['weights'], ref['weights'], 'fit k 4 against k 1')
    windows = _p30_windows(got, ref, 'fit k 4')
    n_win = P30_EPOCHS * (P30_BATCHES // P30_K)
    need(got['graphs'] == (n_win, 1, n_win - 1, 1),
         f'fit k 4: (windows, captures, replays, eager) {got["graphs"]}, '
         f'expected ({n_win}, 1, {n_win - 1}, 1)')
    print(f'phase 30: EDSR-baseline x4 fit --steps_per_execution {P30_K}, '
          f'{steps} steps ({P30_EPOCHS} epochs of {P30_BATCHES} batches: '
          f'{P30_BATCHES // P30_K} windows and {P30_BATCHES % P30_K} '
          f'single steps each): weights equal to k 1\'s bit for bit; '
          f'window losses at steps {windows} equal: '
          + ' '.join(f'{got["losses"][s]:.6f}' for s in windows)
          + f'; windows, captures, replays, eager windows {got["graphs"]}; '
          'launches ' + ', '.join(f'{_counter_name(k)} {got["counts"][k]}'
                                  for k in STEP_LAUNCHES)
          + f' = per step x {steps}; wall {ref["wall"]:.3f} s (k 1) / '
          f'{got["wall"]:.3f} s (k {P30_K}), losses read each check  [{smi}]')

    acc = ['--accumulate_grad_batches', str(P30_ACC), '--max_epochs',
           str(P30_ACC_EPOCHS)]
    steps_acc = P30_BATCHES * P30_ACC_EPOCHS
    ref_acc = _p30_fit(_p30_argv(data, tmp / 'a1', extra=acc),
                       STEP_LAUNCHES, steps_acc, 'fit k 1 accumulate 3')
    got_acc = _p30_fit(_p30_argv(data, tmp / 'a4', extra=acc + k4),
                       STEP_LAUNCHES, steps_acc, 'fit k 4 accumulate 3')
    runs['p30_fit_acc_k1'] = ref_acc['counts']
    runs['p30_fit_acc_k4'] = got_acc['counts']
    _same_weights(got_acc['weights'], ref_acc['weights'],
                  'fit k 4 accumulate 3 against k 1')
    windows = _p30_windows(got_acc, ref_acc, 'fit k 4 accumulate 3')
    phases = {(s - P30_K) % P30_ACC for s in windows}
    n_win = len(windows)
    need(got_acc['graphs'] == (n_win, len(phases), n_win - len(phases),
                               len(phases)),
         f'fit k 4 accumulate 3: (windows, captures, replays, eager) '
         f'{got_acc["graphs"]}: one capture per starting phase '
         f'{sorted(phases)}')
    print(f'phase 30: the same with --accumulate_grad_batches {P30_ACC}, '
          f'{steps_acc} steps: weights equal to k 1\'s bit for bit; window '
          f'losses at steps {windows} equal; starting phases '
          f'{sorted(phases)}; windows, captures, replays, eager windows '
          f'{got_acc["graphs"]}  [{smi}]')

    half = ['--max_epochs', '1']
    knobs = ['--remat', 'true', '--deterministic', 'true', '--profiler_dir']
    # remat runs the forward again in the backward: its launches twice
    remat = {k: v * (2 if k in EXPECTED_LAUNCHES else 1)
             for k, v in STEP_LAUNCHES.items()}
    ref_kn = _p30_fit(_p30_argv(data, tmp / 'n1',
                                extra=knobs + [str(tmp / 'p1')] + half),
                      remat, steps // 2, 'fit k 1 with the knobs')
    got_kn = _p30_fit(_p30_argv(data, tmp / 'n4',
                                extra=knobs + [str(tmp / 'p4')] + half + k4),
                      remat, steps // 2, 'fit k 4 with the knobs')
    runs['p30_fit_knobs'] = {k: ref_kn['counts'][k] + got_kn['counts'][k]
                             for k in remat}
    _same_weights(got_kn['weights'], ref_kn['weights'],
                  'fit k 4 with remat, deterministic, profiler_dir')
    traces = list((tmp / 'p4').glob('*.pt.trace.json'))
    need(len(traces) == 1 and 'cudaGraphLaunch' in traces[0].read_text(),
         f'fit k 4 with profiler_dir: traces {traces} without a graph '
         'launch')
    print(f'phase 30: fit k {P30_K} and k 1 with --remat true '
          '--deterministic true --profiler_dir, one epoch: weights equal '
          f'bit for bit; graphs {got_kn["graphs"]}; the k {P30_K} trace '
          f'({traces[0].stat().st_size} bytes) holds its cudaGraphLaunch '
          f'calls  [{smi}]')
    part = _p30_fit(_p30_argv(data, tmp / 'r', extra=k4 + half),
                    STEP_LAUNCHES, steps // 2, 'fit k 4, first epoch')
    rest = _p30_fit(_p30_argv(data, tmp / 'r',
                              extra=k4 + ['--ckpt_path', 'last']),
                    STEP_LAUNCHES, steps // 2, 'fit k 4, resumed')
    runs['p30_fit_resume'] = {k: part['counts'][k] + rest['counts'][k]
                              for k in STEP_LAUNCHES}
    _same_weights(rest['weights'], got['weights'],
                  'fit k 4 resumed at epoch 1 against the uninterrupted fit')
    print(f'phase 30: fit k {P30_K} stopped after epoch 1 (checkpoint '
          f'"last" at step {steps // 2}) and resumed with --ckpt_path last: '
          f'weights equal to the uninterrupted run bit for bit; graphs of '
          f'the resumed run {rest["graphs"]}  [{smi}]')
    return runs


def _p30_model(name: str, kw: dict, device):
    return create_model(name, scale_factor=SCALE, dtype=torch.bfloat16,
                        device=device,
                        generator=torch.Generator().manual_seed(SEED), **kw)


def _p30_window(device, n: int, k: int, scale: int = SCALE,
                seed: int = SEED) -> list:
    """``n`` windows of ``k`` stacked random batches at the training
    shape, on the card."""
    gen = torch.Generator().manual_seed(seed)
    lr = TRAIN_PATCH // scale
    return [(torch.rand(k, TRAIN_BATCH, lr, lr, 3, generator=gen).to(device),
             torch.rand(k, TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3,
                        generator=gen).to(device)) for _ in range(n)]


def _p30_state_tensors(state) -> dict:
    out = {f'model.{k}': v for k, v in state.model.state_dict().items()}
    for i, (p, st) in enumerate(state.optimizer.state.items()):
        out.update({f'opt.{i}.{k}': v for k, v in st.items()
                    if torch.is_tensor(v)})
    return out


def _p30_pair(net, windows, k: int, opt: str = 'ADAM',
              opt_params=('lr=1e-4',), every: int = 1,
              remat: bool = False) -> tuple:
    """``windows`` through the eager window (``repeat_step``) and
    through a StepGraph, each from a copy of ``net`` (``every`` the
    accumulator's; ``remat`` the step's): (eager state, graph state, the
    StepGraph, each path's counter totals)."""
    from srtpu_torch.train.graph import StepGraph, launch_counters
    from srtpu_torch.train.steps import repeat_step
    comp = parse_losses('l1')
    out, counts = [], []
    for graphed in (False, True):
        m = copy.deepcopy(net)
        state = TrainState.create(m, comp, opt, list(opt_params),
                                  Updater(every))
        step = make_train_step(comp, remat=remat)
        run = StepGraph(step, k) if graphed else repeat_step(step, k)
        counters = launch_counters()
        for fn, attr in counters:
            setattr(fn, attr, 0)
        # the stock head and tail convs' weight grads: cuDNN's default
        # algorithms sum in an order that changes from call to call
        with _cudnn_deterministic():
            for lr, hr in windows:
                run(state, lr, hr)
        torch.cuda.synchronize()
        counts.append({(fn, attr): getattr(fn, attr) for fn, attr in counters})
        out.append((state, run))
    return out[0][0], out[1][0], out[1][1], counts


def _p30_check_pair(eager, graph, sg, counts, what: str, n: int) -> dict:
    a, b = _p30_state_tensors(eager), _p30_state_tensors(graph)
    need(a.keys() == b.keys() and all(torch.equal(a[x], b[x]) for x in a),
         f'{what}: graph against eager not bit for bit (e.g. '
         f'{[x for x in a if not torch.equal(a[x], b[x])][:3]})')
    need(graph.step == eager.step and (sg.captures, sg.replays,
                                       sg.eager_windows) == (1, n - 1, 1),
         f'{what}: step {graph.step} / {eager.step}, captures, replays, '
         f'eager windows {(sg.captures, sg.replays, sg.eager_windows)}')
    need(counts[0] == counts[1],
         f'{what}: launch counters after the graph route differ from the '
         'eager route\'s: ' + ', '.join(
             f'{_counter_name(key)} {counts[1][key]} / {v}'
             for key, v in counts[0].items() if counts[1][key] != v))
    return {key: v for key, v in counts[1].items() if v}


def _p30_routes(device, smi: str) -> dict:
    """(b): every other route that reaches a kernel, and SRCNN."""
    runs = {}
    for label, (name, kw) in P30_ROUTES.items():
        net = _p30_model(name, kw, device)
        windows = _p30_window(device, 2, P30_ROUTE_K)
        eager, graph, sg, counts = _p30_pair(net, windows, P30_ROUTE_K)
        launched = _p30_check_pair(eager, graph, sg, counts, label, 2)
        runs[f'p30_{label.lower().replace(" ", "_")}'] = {
            key: v for key, v in launched.items()}
        print(f'phase 30: {label} x{SCALE} (full width, depth '
              f'{"16, config B" if name == "RDN" else P30_DEPTH}): 2 '
              f'windows of {P30_ROUTE_K} steps, graph against eager bit for '
              'bit (parameters, buffers, Adam\'s state); 1 capture, 1 '
              'replay; launches equal on both routes: ' + (', '.join(
                  f'{_counter_name(key)} {v}' for key, v in launched.items())
                  or 'no kernel') + f'  [{smi}]')
        del net, eager, graph, sg
    return {k: {_counter_key(c): v for c, v in d.items()}
            for k, d in runs.items()}


def _counter_key(c: tuple):
    """A (wrapper, attribute) counter as the kernels' line keys it."""
    fn, attr = c
    return fn if attr == 'launches' else (fn, attr)


def _p30_optimizers(device, smi: str) -> None:
    """(c): the four optimizers on EDSR-baseline x4, graph against eager
    and the first update card against CPU."""
    from srtpu_torch.convert import centralize_plan
    net = _p30_model('EDSR', dict(n_feats=C, n_resblocks=L), device)
    windows = _p30_window(device, 2, P30_K, seed=SEED + 1)
    comp = parse_losses('l1')
    for name in P30_OPTS:
        eager, graph, sg, counts = _p30_pair(net, windows, P30_K, name,
                                             P30_OPT_PARAMS)
        _p30_check_pair(eager, graph, sg, counts, f'{name} (phase 30)', 2)
        # the first update on the same gradients, card and CPU
        m = copy.deepcopy(net)
        lr, hr = windows[0][0][0], windows[0][1][0]
        with _cudnn_deterministic():
            comp(m(lr).float(), hr.float())[0].backward()
        plan = centralize_plan(m)
        params = dict(m.named_parameters())
        # the update alone: both sides step parameters at 0 (the first
        # update reads no parameter without weight decay), so that what
        # is compared is not rounded into the weights' magnitudes
        with torch.no_grad():
            for p in params.values():
                p.zero_()
        host = {n: torch.nn.Parameter(torch.zeros_like(p, device='cpu'))
                for n, p in params.items()}
        for n, p in host.items():
            p.grad = params[n].grad.detach().cpu().clone()
        build_optimizer(name, P30_OPT_PARAMS, params.values(),
                        {params[n]: v for n, v in plan.items()}).step()
        build_optimizer(name, P30_OPT_PARAMS, host.values(),
                        {host[n]: v for n, v in plan.items()}).step()
        err = 0.0
        for n, p in params.items():
            d_card, d_cpu = p.detach().cpu(), host[n].detach()
            scale = float(d_cpu.abs().max())
            if scale > 0:
                err = max(err, float((d_card - d_cpu).abs().max()) / scale)
        need(err <= P30_OPT_TOL, f'{name}: first update card against CPU '
             f'{err:.3g} of its largest magnitude')
        print(f'phase 30: {name} {" ".join(P30_OPT_PARAMS)} on '
              f'EDSR-baseline x4: 2 windows of {P30_K} steps, graph against '
              'eager bit for bit (parameters and optimizer state); first '
              f'update card against CPU on the card\'s gradients '
              f'{err:.3g} of its largest magnitude (tol {P30_OPT_TOL})'
              f'  [{smi}]')
        del eager, graph, sg, m


def _clocks(run, seconds: float = 1.5) -> str:
    """The card's SM and memory clocks while ``run`` repeats for
    ``seconds``: the median and range of ``nvidia-smi``'s samples every
    20 ms (MHz), or "not measured" where it gave none."""
    proc = subprocess.Popen(
        ['nvidia-smi', '--query-gpu=clocks.sm,clocks.mem',
         '--format=csv,noheader,nounits', '-lms', '20'],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            run()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = []
    for line in out.splitlines():
        vals = [v.strip() for v in line.split(',')]
        if len(vals) == 2 and all(v.replace('.', '', 1).isdigit()
                                  for v in vals):
            rows.append([float(v) for v in vals])
    if not rows:
        return 'clocks not measured'
    sm, mem = np.array(rows).T
    return (f'SM clock median {np.median(sm):.0f} MHz ({sm.min():.0f}-'
            f'{sm.max():.0f}), memory {np.median(mem):.0f} MHz '
            f'({mem.min():.0f}-{mem.max():.0f}), {len(rows)} samples')


def _p30_bare(device, name: str, kw: dict) -> tuple:
    """The bare step of ``name`` at k = 1 and k = P30_K (batches on the
    card): ms a step, device ms a step, the clocks, each by k."""
    from srtpu_torch.train.graph import StepGraph
    comp = parse_losses('l1')
    net = _p30_model(name, kw, device)
    (lrs, hrs), = _p30_window(device, 1, P30_K)
    ms, dev, clock = {}, {}, {}
    for k in (1, P30_K):
        state = TrainState.create(copy.deepcopy(net), comp, 'ADAM',
                                  ['lr=1e-4'])
        step = make_train_step(comp)
        if k == 1:
            def run(state=state, step=step):
                for i in range(P30_K):
                    step(state, lrs[i], hrs[i])
        else:
            graph = StepGraph(step, P30_K)

            def run(state=state, graph=graph):
                graph(state, lrs, hrs)
        ms[k] = median_ms(run, launches=1, windows=3) / P30_K
        dev[k] = _all_device_ms(run) / P30_K
        clock[k] = _clocks(run)
    return ms, dev, clock


def _p30_times(device, smi: str, tmp: Path, bare: dict) -> None:
    """(d): the bare step at k = 1 and k = 4 (batches on the card), the
    device's share, and the 20-step fit's wall at both; ``bare[name]``
    the ms a step by k."""
    data = fit_data(tmp, SCALE, TRAIN_PATCH, n=TRAIN_BATCH * P30_BATCHES)
    steps = P30_BATCHES * P30_EPOCHS
    for name, kw in P30_TIMED.items():
        ms, dev, clock = _p30_bare(device, name, kw)
        bare[name] = ms
        share = {k: dev[k] / ms[k] for k in ms}
        walls = {}
        for k in (1, P30_K):
            argv = _p30_argv(data, tmp / f'{name}{k}', name,
                             ['--steps_per_execution', str(k)])
            walls[k] = _p30_fit(argv, {}, steps, f'{name} fit k {k}',
                                spy=False)['wall']
        print(f'phase 30: {name} x{SCALE} train step (batch {TRAIN_BATCH}, '
              f'LR {TRAIN_PATCH // SCALE} -> HR {TRAIN_PATCH}, bf16, L1 + '
              f'Adam; CUDA events, median of 3 windows of {P30_K} steps, '
              'batches on the card): ' + '; '.join(
                  f'k {k}: {ms[k]:.3f} ms/step, device {dev[k]:.3f} ms/step '
                  f'(torch.profiler), device share {share[k]:.3f}, '
                  f'{clock[k]} over 1.5 s of steps' for k in ms)
              + f'; {steps}-step fit wall (CLI, incl. model init, .npy '
              'reads, run assets): ' + ', '.join(
                  f'k {k} {w:.3f} s' for k, w in walls.items())
              + f'  [{smi}]')


def _p30_capture_fails(device, smi: str) -> None:
    """A step that reads the device from the host cannot be captured:
    the StepGraph raises, it does not run the window eagerly."""
    from srtpu_torch.train.graph import StepGraph
    net = _p30_model('EDSR', dict(n_feats=C, n_resblocks=P30_DEPTH), device)
    comp = parse_losses('l1')
    state = TrainState.create(net, comp, 'ADAM', ['lr=1e-4'])
    step = make_train_step(comp)

    def reads_host(state, lr, hr):
        logs = step(state, lr, hr)
        float(logs['loss'])
        return logs
    graph = StepGraph(reads_host, P30_ROUTE_K)
    (lrs, hrs), = _p30_window(device, 1, P30_ROUTE_K)
    try:
        graph(state, lrs, hrs)
    except RuntimeError as e:
        raised = str(e).splitlines()[0][:160]
    else:
        raised = None
    need(raised is not None and graph.captures == 0,
         'a step with a host read was captured, or ran without raising')
    print(f'phase 30: a step that reads its loss on the host: the capture '
          f'raised ({raised}); no eager fallback  [{smi}]')


def run_phase30(device, smi: str, bare: dict | None = None) -> dict:
    """Phase 30 (the module note). Returns the launch counts of its
    main-path runs; (d)'s bare steps (ms by k) go into ``bare``."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='srtpu_smoke_p30_') as tmp:
        tmp = Path(tmp)
        runs = _p30_cli(device, smi, tmp / 'a')
        runs.update(_p30_routes(device, smi))
        _p30_optimizers(device, smi)
        _p30_times(device, smi, tmp / 'd', {} if bare is None else bare)
        _p30_capture_fails(device, smi)
    print(f'phase 30 took {time.perf_counter() - t0:.1f} s')
    return runs


# ----------------------------------------------------------- phase 31

P31_IMAGES = 800            # DIV2K's training images: 50 batches of 16
P31_HR = 256                # HR 256x256, LR 64x64 at x4, uint8 .npy
P31_EPOCHS = 3              # epoch 1 fills the RAM cache and captures
P31_K = 4
P31_PRODUCER = 'srtpu-torch-train-producer'


def p31_data(root: Path) -> Path:
    """P31_IMAGES uint8 HR images of P31_HR squared drawn from SEED and
    their box-filtered LR at x4; returns the datasets directory."""
    rng = np.random.default_rng(SEED)
    data = root / 'datasets'
    hr_dir = data / 'Train' / 'HR'
    lr_dir = data / 'Train' / 'LR' / f'X{SCALE}'
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    n = P31_HR // SCALE
    for i in range(P31_IMAGES):
        hr = rng.integers(0, 256, (P31_HR, P31_HR, 3), dtype=np.uint8)
        lr = hr.reshape(n, SCALE, n, SCALE, 3).mean((1, 3))
        np.save(hr_dir / f'{i:03d}.npy', hr)
        np.save(lr_dir / f'{i:03d}.npy', (lr + 0.5).astype(np.uint8))
    return data


def _p31_source(data: Path):
    from srtpu_torch.data import ConcatSource, NpySource
    train = data / 'Train'
    return ConcatSource([NpySource(train / 'HR', train / 'LR' / f'X{SCALE}',
                                   SCALE, cache=True)])


def _p31_loader(source, device, workers: int, core: str):
    """The fit's loader on ``source`` (seed SEED, prefetch 2), on ``core``
    (the numpy core by reporting the native one unavailable)."""
    from srtpu_torch.data import TrainLoader
    from srtpu_torch.data import native as data_native
    with mock.patch.object(data_native, 'available',
                           return_value=core == 'native'):
        loader = TrainLoader(source, TRAIN_BATCH, TRAIN_PATCH, SCALE,
                             seed=SEED, device=device, num_workers=workers)
    need(loader.core == core, f'loader core {loader.core}, wanted {core}')
    return loader


def _p31_rates(device, smi: str, data: Path) -> dict:
    """(a) and (b): the loader alone. Returns patches/s by (core,
    workers)."""
    from srtpu_torch.data import native as data_native
    need(data_native.available(), 'the native patch core did not build on '
         'the card\'s machine')
    source = _p31_source(data)
    t0 = time.perf_counter()
    for i in range(len(source)):
        source.get(i)
    fill = time.perf_counter() - t0
    rates = {}
    for core in ('numpy', 'native'):
        for workers in (1, 0):
            loader = _p31_loader(source, device, workers, core)
            for _ in loader:            # the ring, the stream, the pool
                pass
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = sum(b.lr.shape[0] for b in loader)
            torch.cuda.synchronize()
            rates[core, workers] = n / (time.perf_counter() - t0)
            loader.close()
    # (b): the card's batches, copied back, against the host loader's
    dev = _p31_loader(source, device, 0, 'native')
    host = _p31_loader(source, None, 1, 'numpy')
    n = 0
    for _ in range(2):
        for a, b in zip(dev, host, strict=True):
            need(a.lr.is_cuda and torch.equal(a.lr.cpu(),
                                              torch.from_numpy(b.lr))
                 and torch.equal(a.hr.cpu(), torch.from_numpy(b.hr))
                 and a.names == b.names,
                 f'batch {n}: the card\'s batch is not the host loader\'s')
            n += 1
    dev.close()
    print(f'phase 31: the loader alone ({P31_IMAGES} images, batch '
          f'{TRAIN_BATCH}, patch {TRAIN_PATCH} x{SCALE}, prefetch 2, batches '
          f'prefetched to the card; its RAM cache filled in {fill:.2f} s), '
          'patches/s over an epoch: ' + ', '.join(
              f'{core} core {"auto" if w == 0 else w} worker'
              f'{"s" if w != 1 else ""} ({os.cpu_count()} cores) {r:.1f}'
              for (core, w), r in rates.items())
          + f'; {n} batches of two epochs on the card (native core, auto '
          'workers) equal to the host loader\'s (numpy core) bit for bit  '
          f'[{smi}]')
    return rates


class _EpochLog(logging.Handler):
    """The fit's per-epoch ``items/s``."""

    def __init__(self):
        super().__init__()
        self.rates = []

    def emit(self, record):
        if record.msg.startswith('epoch %d/%d'):
            self.rates.append(float(record.args[-1]))


def _p31_fit(argv, steps: int, what: str) -> dict:
    """``_p30_fit`` (cuDNN's deterministic algorithms, the losses at each
    progress check) with the feed timed: per epoch the consumer's
    seconds blocked in ``next()`` and its batches, each batch's copy to
    the card (events on the producer's stream, read after), whether a
    producer thread was live at each capture, the epochs' items/s."""
    from srtpu_torch.data import TrainLoader
    from srtpu_torch.train.graph import StepGraph
    real_iter, real_copy = TrainLoader.__iter__, TrainLoader._to_device
    real_capture = StepGraph._capture
    waits, copies, live = [], [], []

    def timed_iter(self):
        it, rec = real_iter(self), [0.0, 0]
        waits.append(rec)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                rec[0] += time.perf_counter() - t0
                rec[1] += 1
                yield batch
        finally:
            it.close()

    def timed_copy(self, lr, hr, stream):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = real_copy(self, lr, hr, stream)
        end.record(stream)
        copies.append((start, end))
        return out

    def capture(self, *args):
        live.append(any(t.name == P31_PRODUCER and t.is_alive()
                        for t in threading.enumerate()))
        return real_capture(self, *args)

    log = _EpochLog()
    logger = logging.getLogger('srtpu_torch.train.loop')
    logger.addHandler(log)
    try:
        with mock.patch.object(TrainLoader, '__iter__', timed_iter), \
                mock.patch.object(TrainLoader, '_to_device', timed_copy), \
                mock.patch.object(StepGraph, '_capture', capture):
            run = _p30_fit(argv, STEP_LAUNCHES, steps, what)
    finally:
        logger.removeHandler(log)
    torch.cuda.synchronize()
    run.update(waits=waits, live=live, rates=log.rates,
               copy_ms=[a.elapsed_time(b) for a, b in copies])
    root = Path(argv[argv.index('--default_root_dir') + 1])
    need('train loader: the native core, batches prefetched to cuda'
         in (root / 'run.log').read_text(),
         f'{what}: run.log names no native core on the card')
    return run


def run_phase31(device, smi: str, bare: dict | None = None) -> dict:
    """Phase 31 (the module note). Returns the launch counts of its fits;
    ``bare`` is phase 30's bare EDSR step (ms by k), measured here when
    phase 30 did not run."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='srtpu_smoke_p31_') as tmp:
        tmp = Path(tmp)
        data = p31_data(tmp)
        made = time.perf_counter() - t0
        _p31_rates(device, smi, data)
        steps = P31_EPOCHS * (P31_IMAGES // TRAIN_BATCH)
        epochs = ['--max_epochs', str(P31_EPOCHS)]
        k1 = _p31_fit(_p30_argv(data, tmp / 'k1', extra=epochs), steps,
                      'fit k 1 (phase 31)')
        k4 = _p31_fit(_p30_argv(data, tmp / 'k4', extra=epochs + [
            '--steps_per_execution', str(P31_K)]), steps,
            'fit k 4 (phase 31)')
    _same_weights(k4['weights'], k1['weights'], 'phase 31: fit k 4 against '
                  'k 1')
    n_win = P31_EPOCHS * (P31_IMAGES // TRAIN_BATCH // P31_K)
    need(k4['graphs'] == (n_win, 1, n_win - 1, 1),
         f'phase 31 fit k 4: (windows, captures, replays, eager) '
         f'{k4["graphs"]}, expected ({n_win}, 1, {n_win - 1}, 1)')
    need(k4['live'] and all(k4['live']),
         f'phase 31: captures with a live producer {k4["live"]}')
    if not bare:
        bare = _p30_bare(device, 'EDSR', P30_TIMED['EDSR'])[0]
        where = 'measured here'
    else:
        bare = bare['EDSR']
        where = 'phase 30'
    for k, run in ((1, k1), (P31_K, k4)):
        rates = run['rates'][1:]
        need(len(rates) == P31_EPOCHS - 1, f'epoch lines {run["rates"]}')
        rate = float(np.mean(rates))
        wait = [w / max(n, 1) * 1e3 for w, n in run['waits'][1:]]
        copy_ms = run['copy_ms']
        print(f'phase 31: EDSR-baseline x{SCALE} fit k {k}, {P31_EPOCHS} '
              f'epochs of {P31_IMAGES // TRAIN_BATCH} batches (native core, '
              'auto workers, prefetch 2, batches prefetched to the card): '
              f'epochs 2-{P31_EPOCHS} {TRAIN_BATCH * 1e3 / rate:.3f} ms a '
              f'step, {rate:.1f} patches/s (epoch 1 {run["rates"][0]:.1f}); '
              'the consumer\'s wait in next() a step '
              + ', '.join(f'{w:.3f}' for w in wait) + ' ms (epoch 1 '
              f'{run["waits"][0][0] / max(run["waits"][0][1], 1) * 1e3:.3f}); '
              f'the copy to the card a batch median {np.median(copy_ms):.4f}'
              f' ms ({min(copy_ms):.4f}-{max(copy_ms):.4f}, {len(copy_ms)} '
              f'copies); the bare step ({where}) {bare[k]:.3f} ms; wall '
              f'{run["wall"]:.3f} s  [{smi}]')
    print(f'phase 31: fit k {P31_K} weights equal to k 1\'s bit for bit; '
          f'windows, captures, replays, eager windows {k4["graphs"]}; '
          f'{len(k4["live"])} capture(s), each with the producer thread live; '
          f'run.log names the native core; launches per step x {steps}; '
          f'data made in {made:.2f} s; phase 31 took '
          f'{time.perf_counter() - t0:.1f} s')
    return {'p31_fit_k1': k1['counts'], 'p31_fit_k4': k4['counts']}


def run_true_routes(device, smi: str) -> dict:
    """Phases 19-21 (the module note): each True route's predict and fit,
    with the 'cs' route of the same weights beside. Returns their launch
    counts."""
    runs = {}
    for model, args, (pred, step) in (
            ('EDSR', TRUE_ARGS, (EDSR_TRUE_LAUNCHES, EDSR_TRUE_STEP_LAUNCHES)),
            ('RCAN', RCAN_ARGS + TRUE_ARGS,
             (RCAN_TRUE_LAUNCHES, RCAN_TRUE_STEP_LAUNCHES)),
            ('WDSR', WDSR_ARGS + TRUE_ARGS,
             (WDSR_TRUE_LAUNCHES, WDSR_TRUE_STEP_LAUNCHES))):
        key = model.lower() + '_true'
        runs[key + '_predict'] = run_slice(device, smi, model, args, pred,
                                           alt=CS_ROUTE,
                                           sizes=SLICE_SIZES[:1])
        runs[key + '_fit'] = run_train(device, smi, model, args, step, None,
                                       steps=TRUE_FIT_STEPS,
                                       timing=TRUE_TIMING)
    return runs


# ----------------------------------------------------------- phase 32

# srtpu's XLA routes at full width: (model, CLI flags, scale, fit too);
# no kernel of the port runs on them, forward or backward
# RDN-B's predict runs at --precision 32, the others' in bf16
P32_ROUTES = (('SRResNet', ['--use_pallas', 'false'], SCALE, True),
              ('RDN', ['--rdn_config', 'A'], SCALE, True),
              ('RDN', RDN_ARGS + ['--use_pallas', 'false'], SCALE, False),
              ('DDBPN', DDBPN_ARGS + ['--use_pallas', 'false'], SCALE, True),
              ('DDBPN', DDBPN_ARGS, 8, True))
P32_STEPS = 10
# the card's eval forward against the CPU's, one LR image of this side
P32_CPU_SIDE = 32
P32_CPU_TOL = 2.0 ** -7
# every launch counter of the port: each must stay at 0 on these routes
NO_PORT_KERNEL = {k: 0 for d in (
    NO_KERNEL, STEP_LAUNCHES, RCAN_STEP_LAUNCHES, SRRESNET_STEP_LAUNCHES,
    RDN_STEP_LAUNCHES, DDBPN_STEP_LAUNCHES, WDSR_STEP_LAUNCHES,
    SRGAN_STEP_LAUNCHES, SRRESNET_X3_STEP_LAUNCHES, EDSR_TRUE_STEP_LAUNCHES,
    RCAN_TRUE_STEP_LAUNCHES, WDSR_TRUE_STEP_LAUNCHES,
    {CONV5_BWD: 0, K2G5_BWD: 0, rdb_bwd_dw: 0, resblock_fused_fwd: 0,
     resblock_bwd_fused: 0, ca_layer_fwd: 0, wdsr_block_fused_fwd: 0,
     **{k: 0 for k in K4R_COUNTERS.values()}}) for k in d}


def _grads_stock(model: str, net, lr, hr, paths) -> None:
    """Phase 32's train step: on a route without a kernel both paths run
    the same stock ops, so every gradient is finite and within
    STEP_GRAD_TOL of the other path's largest; a conv bias right before
    a batch norm (SRResNet's PRE_BN: its exact gradient is 0, each path's
    rounding noise) within that of its conv kernel's largest."""
    grads = [dict(paths[plain][1].model.named_parameters())
             for plain in (False, True)]
    worst = (0.0, '')
    for name, pk in grads[0].items():
        gk, gp = pk.grad, grads[1][name].grad
        need(bool(torch.isfinite(gk).all()), f'{name}: gradient not finite')
        leaf = name.rsplit('.', 1)[-1]
        if model == 'SRResNet' and leaf in PRE_BN:
            w = {'b1': 'w1', 'b2': 'w2', 'close_b': 'close_w'}[leaf]
            lim = STEP_GRAD_TOL * grads[1][name.replace(leaf, w)].grad \
                .abs().max()
            need(bool(gk.abs().max() <= lim and gp.abs().max() <= lim),
                 f'{name}: a pre-BN bias gradient above noise')
            continue
        rel = ((gk - gp).abs().max() / gp.abs().max()).item()
        worst = max(worst, (rel, name))
    print(f'{model} train step (stock route), path against path: worst '
          f'gradient max_abs/max|ref| {worst[1]} {worst[0]:.4g} (tol '
          f'{STEP_GRAD_TOL:.4g})')
    need(worst[0] <= STEP_GRAD_TOL, f'{worst[1]} gradient')


def _p32_card_vs_cpu(device, smi: str, model: str, flags, scale: int):
    """The model of ``flags`` drawn from SEED on the card, its parameters
    and buffers copied to the CPU: the eval forward of one LR image on
    each, within P32_CPU_TOL of the CPU's largest magnitude."""
    argv = ['predict', '--model', model, '--scale_factor', str(scale),
            '--n_feats', str(C), '--n_resblocks', str(L), *flags,
            '--precision', 'bf16', '--seed', str(SEED)]
    args = cli.build_parser().parse_args(argv)
    net = cli.build_model(args, device).eval()
    cpu = cli.build_model(args, torch.device('cpu')).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    lr = torch.from_numpy(np.random.default_rng(SEED).random(
        (1, P32_CPU_SIDE, P32_CPU_SIDE, 3), np.float32))
    with torch.inference_mode():
        got = net(lr.to(device)).float().cpu()
        t0 = time.perf_counter()
        ref = cpu(lr).float()
        cpu_s = time.perf_counter() - t0
    need(got.shape == ref.shape == (1, scale * P32_CPU_SIDE,
                                    scale * P32_CPU_SIDE, 3)
         and bool(torch.isfinite(got).all()), f'{model}: SR shape or values')
    err, top = (got - ref).abs().max().item(), ref.abs().max().item()
    print(f'phase 32: {model} x{scale} {" ".join(flags)} eval forward, card '
          f'against CPU (LR {P32_CPU_SIDE}x{P32_CPU_SIDE}, bf16): max_abs '
          f'{err:.4g} of max {top:.4g} (tol {P32_CPU_TOL:.4g} of it); CPU '
          f'forward {cpu_s:.3f} s  [{smi}]')
    need(err <= P32_CPU_TOL * top, f'{model} {flags}: card against CPU')


def run_phase32(device, smi: str) -> dict:
    """Phase 32 (the module note). Returns the launch counts of its runs,
    every one 0 (no row of the kernels line counts them)."""
    runs = {}
    for model, flags, scale, fit in P32_ROUTES:
        print(f'phase 32: {model} x{scale} {" ".join(flags)}: no kernel of '
              "the port runs on this route (srtpu's XLA math, stock ops)")
        key = f'{model.lower()}_x{scale}_{"_".join(flags[-2:])}'
        runs[key + '_predict'] = run_slice(
            device, smi, model, flags, NO_PORT_KERNEL, scale=scale,
            sizes=SLICE_SIZES[:1], precision='bf16' if fit else '32')
        if fit:
            runs[key + '_fit'] = run_train(
                device, smi, model, flags, NO_PORT_KERNEL, STOCK_RULES,
                _grads_stock, scale=scale, steps=P32_STEPS,
                timing=TRUE_TIMING)
    for model, flags, scale, _ in P32_ROUTES:
        _p32_card_vs_cpu(device, smi, model, flags, scale)
    for counts in runs.values():
        need(not any(counts.values()), f'phase 32: a kernel ran: {counts}')
    return runs


def main() -> None:
    t_start = time.perf_counter()
    # phase 28's deterministic fits need it before the first cuBLAS call
    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG',
                          train_loop.CUBLAS_DETERMINISTIC)

    def lap(what: str) -> None:
        print(f'chip_smoke: {what} done at {time.perf_counter() - t_start:.1f}'
              ' s', flush=True)
    device, smi = card()
    stats = check_kernels(device)
    stats.update(check_bwd_kernels(device, smi))
    _k3_times(device, smi, stats)
    lap('phases 2 and 2b')
    stats.update(check_rcab_kernels(device, smi))
    stats.update(check_bn_kernels(device, smi))
    stats.update(check_rdn_kernels(device, smi))
    stats.update(check_k2_general(device, smi))
    stats.update(check_k2_train_fwd(device, smi))
    stats['W']['classes'], w_err = check_w_classes(device, smi)
    stats['W']['max_abs_err'] = max(stats['W']['max_abs_err'], w_err)
    stats.update(check_wdsr_kernels(device, smi))
    stats.update(check_bn_reflect_kernels(device, smi))
    stats.update(check_bn_trunk(device, smi))
    lap('phases 2c-2h, 2k, 2l and 2n')
    stats.update(check_k8_kernels(device, smi))
    lap('phase 2i')
    stats.update(check_form_kernels(device, smi))
    check_trunk_times(device, smi, stats)
    lap('phases 2j and 2m')
    # the main-path runs, each with the counters set to 0 before it
    runs = run_op_paths(device, smi)
    runs['edsr_predict'] = run_slice(device, smi)
    runs['edsr_fit'] = run_train(device, smi)
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
    lap('the op runs and phases 3-18')
    runs.update(run_true_routes(device, smi))
    lap('phases 19-21')
    runs['edsr86_fit'] = run_train(device, smi, 'EDSR', EDSR86_ARGS,
                                   EDSR86_STEP_LAUNCHES, EDSR_PROFILE,
                                   steps=EDSR86_STEPS)
    print('EDSR x4 256 features / 32 resblocks / res_scale 0.1: no kernel '
          "of the port runs on this path (srtpu's XLA trunk and tail past "
          '96 features, stock PyTorch ops here)')
    runs['edsr_big_predict'] = run_slice(device, smi, 'EDSR', EDSR_BIG_ARGS,
                                         NO_KERNEL, STOCK_RULES,
                                         sizes=SLICE_SIZES[:1])
    runs['edsr_big_fit'] = run_train(device, smi, 'EDSR', EDSR_BIG_ARGS,
                                     NO_KERNEL, STOCK_RULES,
                                     steps=EDSR_BIG_STEPS)
    lap('phases 22 and 23')
    print('SRCNN x4: no kernel of the port runs on this path (srtpu leaves '
          'its bicubic matmuls and three convs to XLA; cuDNN and cuBLAS '
          'here)')
    runs['srcnn_predict'] = run_slice(device, smi, 'SRCNN', (),
                                      SRCNN_LAUNCHES, STOCK_RULES)
    runs['srcnn_fit'] = run_train(device, smi, 'SRCNN', (), SRCNN_LAUNCHES,
                                  STOCK_RULES)
    runs['edsr_validate'] = run_validate(device, smi)
    runs['rcan_validate'] = run_validate(device, smi, 'RCAN', RCAN_ARGS,
                                         RCAN_PREDICT_LAUNCHES, full=False)
    runs.update(run_tiled(device, smi, stats))
    lap('phases 24-26')
    runs.update(run_fit_val(device, smi, then=run_phase28))
    lap('phases 27 and 28')
    runs.update(run_phase29(device, smi))
    lap('phase 29')
    bare = {}
    runs.update(run_phase30(device, smi, bare))
    lap('phase 30')
    runs.update(run_phase31(device, smi, bare))
    lap('phase 31')
    run_phase32(device, smi)
    lap('phase 32')
    rep = 'srtpu/ops/cs_conv.py:'
    bn = 'srtpu/ops/bn_resblock_cs.py:'
    meta = [('K1', 'K1 trunk_fwd (per block conv1 at K2 EPI 0, conv2 at '
             'EPI 6 on K2\'s engine; one host call)', trunk_fwd, 'trunk.cu',
             rep + '1496'),
            ('K2', 'K2 conv3x3_fwd', conv3x3_fwd, 'conv.cu', rep + '538'),
            ('K3', "K3 upsample_fwd (64 -> 256 on K2's engine at EPI 13: "
             'N 128, two phases a block, the pixel shuffle in the store)',
             upsample_fwd, 'upsample.cu', rep + '952'),
            ('K1b', 'K1 trunk_bwd (dx chain: two transposed launches of K2\'s '
             'engine a block at EPI 5, a gs pass where res_scale != 1, one '
             'host call; with its weight grads)', trunk_bwd, 'trunk.cu',
             rep + '1527'),
            ('K2b', 'K2 conv3x3_bwd (dx; with its weight grads)', conv3x3_bwd,
             'conv.cu', rep + '581'),
            ('K3b', "K3 upsample_bwd (dx on K2's transposed engine at EPI "
             "14, the fine cotangent read phase-major through a 5-D tensor "
             'map; with its weight grads)', upsample_bwd, 'upsample.cu',
             rep + '975'),
            ('W', 'conv_wgrad (dW, db of the K1/K2/K3/K5 backward passes)',
             conv_wgrad, 'wgrad.cu', rep + '452'),
            ('K5', 'K5 rcab_fwd (RCAB conv pair, pool + MLP, gate)',
             rcab_fwd, 'rcab.cu', rep + '2593'),
            ('K5b', 'K5 rcab_bwd (pool sums, MLP bwd, dr2, dx chain; with its '
             'weight grads)', rcab_bwd, 'rcab.cu', rep + '2618'),
            ('K25', 'K2 conv3x3_fwd at 5x5 (SRResNet phase-dense 256->16)',
             CONV5_FWD, 'conv.cu', rep + '538'),
            ('K2t', 'K2 conv3x3_fwd at the training shape (EDSR x4 tail: '
             '64->64, 64->256, 256->16)', conv3x3_fwd, 'conv.cu',
             rep + '538', ('edsr_fit',)),
            ('K25t', 'K2 conv3x3_fwd at 5x5 at the training shape (SRResNet '
             '256->16)', CONV5_FWD, 'conv.cu', rep + '538',
             ('srresnet_fit',)),
            ('K2gt', 'K2 conv3x3_fwd at the training shape (DDBPN x4 '
             '32->512, 512->32, 512->48)', K2G_FWD, 'conv.cu', rep + '538',
             ('ddbpn_fit',)),
            ('K2x3t', 'K2 conv3x3_fwd at the training shape (x3 tails: EDSR '
             '64->576, 576->32; SRResNet 5x5 576->32)',
             [conv3x3_fwd, K2G_FWD, K2G5_FWD], 'conv.cu', rep + '538',
             ('edsr_x3', 'srresnet_x3')),
            ('K25b', 'K2 conv3x3_bwd at 5x5 (dx 16->256; with its 5x5 '
             'weight grads)', CONV5_BWD, 'conv.cu', rep + '581'),
            ('F1', 'K4 f1_conv_stats (conv + bias on K2 engine EPI 9, stats '
             'of the stored y; reduce + finalize)', f1_conv_stats,
             'bn_block.cu', bn + '315', ('bn_block',)),
            ('F2', 'K4 f2_norm_act_conv_stats (h1 = prelu(BN1) pass, conv '
             'on K2 engine EPI 9, stats)', f2_norm_act_conv_stats,
             'bn_block.cu', bn + '324', ('bn_block',)),
            ('F3', 'K4 f3_norm_skip', f3_norm_skip, 'bn_block.cu',
             bn + '333', ('bn_block',)),
            ('B1', 'K4 b1_sums (S_g, S_gx)', b1_sums, 'bn_block.cu',
             bn + '346', ('bn_block',)),
            ('B2', 'K4 b2_call (BN2 bwd dy pass, convT + PReLU bwd + BN1 '
             'sums on K2 engine TB EPI 10)', b2_call, 'bn_block.cu',
             bn + '360', ('bn_block',)),
            ('B3', 'K4 b3_call (BN1 bwd dy pass, convT + skip on K2 engine '
             'TB EPI 11)', b3_call, 'bn_block.cu', bn + '387',
             ('bn_block',)),
            ('K4t', 'K4 bn_trunk_fwd (SRResNet BN trunk, one host call: per '
             'block F1, h1 pass, F2 on K2 engine EPI 9, F3; the close)',
             K4T[False][0], 'bn_block.cu', bn + '435'),
            ('K4tb', 'K4 bn_trunk_bwd (one host call: per block B1, dy '
             'passes, B2 / B3 on K2 engine TB EPI 10 / 11; the 33 weight '
             'grads in one W launch)', K4T[False][1], 'bn_block.cu',
             bn + '490'),
            ('K6', 'K6 rdn_fwd (16 dense blocks: 8 dense layers + the 1x1 '
             'fusion each; saving)', rdn_fwd, 'rdn.cu', rep + '2174'),
            ('K6b', 'K6 rdb_bwd_chain (one block: fusion bwd, dwf, dx chain, '
             'db)', rdb_bwd_chain, 'rdn.cu', rep + '2265'),
            ('K6w', 'K6 rdb_bwd_dw (one block: 36 pair weight grads)',
             rdb_bwd_dw, 'rdn.cu', rep + '2340'),
            ('K2g', 'K2 conv3x3_fwd, general shapes (DDBPN x4 32->512, '
             '512->32, 512->48; EDSR x3 576->32)', K2G_FWD,
             'conv.cu', rep + '538'),
            ('K2gb', 'K2 conv3x3_bwd, general shapes (dx 512->32, 32->512, '
             '48->512; with its weight grads)', K2G_BWD, 'conv.cu',
             rep + '581'),
            ('Wg', 'conv_wgrad, general path (dW, db of DDBPN x4: (32, 512),'
             ' (512, 32), (512, 48))', WGG, 'wgrad.cu', rep + '452'),
            ('K2g5', 'K2 conv3x3_fwd at 5x5, general shapes (SRResNet x3 '
             '576->32)', K2G5_FWD, 'conv.cu', rep + '538'),
            ('K2g5b', 'K2 conv3x3_bwd at 5x5, general shapes (SRResNet x3 dx '
             '32->576; with its weight grads)', K2G5_BWD, 'conv.cu',
             rep + '581'),
            ('K7', 'K7 wdsr_trunk_fwd (WDSR-B blocks, one host call a '
             'trunk: chained 1x1 pair with h1 in registers; 3x3 + res_scale '
             '+ skip on K2 engine EPI 8)', wdsr_fwd, 'wdsr.cu',
             'srtpu/ops/wdsr_cs.py:135'),
            ('K7b', 'K7 wdsr_trunk_bwd (one host call a trunk: dh2 on K2 '
             'engine TB EPI 7, chained pointwise bwd with h1 recomputed, '
             'dW1 dW2 dW3 db3 on W engine, db1 db2 fixed-order sums)',
             wdsr_bwd, 'wdsr.cu', 'srtpu/ops/wdsr_cs.py:159'),
            ('F1r', 'K4r f1_conv_stats, reflect (halo mirrored in shared '
             'memory after the TMA load; stats of the stored y)',
             K4R_COUNTERS['F1'], 'bn_block.cu', bn + '315', ('bn_block',)),
            ('F2r', 'K4r f2_norm_act_conv_stats, reflect (h1 of the '
             'mirrored pixel in the halo)', K4R_COUNTERS['F2'],
             'bn_block.cu', bn + '324', ('bn_block',)),
            ('B2r', 'K4r b2_call, reflect (fold ring launch, convT + fold '
             'before the PReLU bwd and BN1 sums)', K4R_COUNTERS['B2'],
             'bn_block.cu', bn + '360', ('bn_block',)),
            ('B3r', 'K4r b3_call, reflect (fold ring launch, convT + fold '
             'before the skip and its rounding)', K4R_COUNTERS['B3'],
             'bn_block.cu', bn + '387', ('bn_block',)),
            ('K4rt', 'K4r bn_trunk_fwd, reflect (SRGAN generator trunk, one '
             'host call)', K4T[True][0], 'bn_block.cu', bn + '435'),
            ('K4rtb', 'K4r bn_trunk_bwd, reflect (one host call; fold ring '
             'launches; the 33 reflect weight grads in one W launch)',
             K4T[True][1], 'bn_block.cu', bn + '490'),
            ('K8a', "K8a resblock_trunk_fwd / resblock_fused_fwd (EDSR "
             "use_pallas=True: per block conv1 on K2's engine at EPI 12, "
             'f32 h1 stored as bf16 [hi | lo], conv2 over the pair at EPI '
             '15; one host call a trunk; a block saving h1)',
             [resblock_fused_fwd, resblock_trunk_fwd], 'resblock.cu',
             'srtpu/ops/resblock.py:165'),
            ('K8b', 'K8b ca_layer_fwd (RCAN use_pallas=True: two launches, '
             'fixed-order partial sums, then gate + gating in every block)',
             ca_layer_fwd,
             'ca_layer.cu', 'srtpu/ops/ca_layer.py:41'),
            ('K8c', 'K8c wdsr_block_fused_fwd (WDSR-B use_pallas=True: '
             'chained 1x1 pair with f32 a and v as hi + lo, 3x3 over [hi | '
             'lo] + res_scale + skip on K2 engine EPI 8)',
             wdsr_block_fused_fwd, 'wdsr.cu', 'srtpu/ops/wdsr_block.py:71'),
            ('K1s', "K1 trunk_fwd as srtpu's per-block trunk_cs (EDSR 64 x "
             '86, one host call)', trunk_fwd,
             'trunk.cu', rep + '1271', ('edsr86',)),
            ('K1sb', "K1 trunk_bwd as srtpu's per-block trunk_cs (dx chain; "
             'with its weight grads; EDSR 64 x 86)',
             trunk_bwd, 'trunk.cu', rep + '1297', ('edsr86',)),
            ('K9a', 'K1 trunk_fwd at L = 1 as srtpu resblock_cs (one '
             'resblock on HWIO weights, saving h1)', trunk_fwd, 'trunk.cu',
             rep + '749', ('resblock_cs',)),
            ('K9ab', 'K1 trunk_bwd at L = 1 as srtpu resblock_cs (dx chain; '
             'with its weight grads)', trunk_bwd, 'trunk.cu', rep + '771',
             ('resblock_cs',)),
            ('K9b', "K6 rdn_fwd at D = 1 as srtpu rdb_fused_fwd (RDN's calls "
             'trunk: one dense block per call, 8 layers + the 1x1 fusion, '
             'saving its buffer)', rdn_fwd, 'rdn.cu', rep + '1843',
             ('rdn_calls',)),
            ('K9bc', 'K6 rdb_bwd_chain on the calls trunk (one block; its '
             'cotangent rounded once before)', rdb_bwd_chain, 'rdn.cu',
             rep + '1922', ('rdn_calls',)),
            ('K9bw', 'K6 rdb_bwd_dw on the calls trunk (one block: 36 pair '
             'weight grads)', rdb_bwd_dw, 'rdn.cu', rep + '1990',
             ('rdn_calls',)),
            ('K9c', 'K9c conv3x3_fwd per dense layer of rdn_trunk_layers '
             '(c_in 64 (i + 1) -> 64 + ReLU; 8 layers of one block)',
             [conv3x3_fwd, K2G_FWD], 'conv.cu', rep + '1623',
             ('rdn_layers',)),
            ('K9cb', 'K9c conv3x3_bwd per dense layer (dx 64 -> c_in; with '
             'its weight grads; 8 layers of one block)',
             [conv3x3_bwd, K2G_BWD], 'conv.cu', rep + '1648',
             ('rdn_layers',)),
            ('K9d', "K9d resblock_bwd_fused (K8a's backward: gs and dh1 as "
             "bf16 hi + lo, its two transposed convs on K2's wgmma engine "
             "at EPI 16 / 17, weight grads on W's, fold)",
             resblock_bwd_fused, 'resblock_bwd.cu',
             'srtpu/ops/resblock.py:316')]
    rows = []
    for kid, name, fn, src, r, *only in meta:
        st = stats[kid]
        keys = fn if isinstance(fn, list) else [fn]
        by_path = {path: sum(counts.get(k, 0) for k in keys)
                   for path, counts in runs.items()
                   if not only or path.startswith(only[0])}
        need(sum(by_path.values()) > 0, f'{name}: no main-path launch')
        rows.append({
            'name': name, 'route': 'cuda',
            'source': 'srtpu_torch/ops/csrc/' + src, 'replaces': r,
            'launches': sum(by_path.values()), 'launches_by_path': by_path,
            'max_abs_err': st['max_abs_err'], 'ms': st['ms'],
            'plain_ms': st['plain_ms'], 'bound_ms': st['bound_ms'],
            'bound_by': ('operations' if st['ops_ms'] >= st['bytes_ms']
                         else 'bytes'),
            'library_ms': st['library_ms'],
            **{key: st[key] for key in ('library_bench_ms', 'dx_ms',
                                        'dx_bound_ms', 'wgrad_ms',
                                        'wgrad_bound_ms', 'wgrad_library_ms',
                                        'wgrad_library_bench_ms', 'classes',
                                        'device_ms', 'host_ms',
                                        'chain_device_ms', 'dx_device_ms',
                                        'reference_ms',
                                        'reference_device_ms',
                                        'trunk_device_ms', 'trunk_host_ms',
                                        'trunk_reference_device_ms')
               if st.get(key) is not None}})
    print(f'chip_smoke ran {time.perf_counter() - t_start:.1f} s '
          f'(kernel build included)')
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
