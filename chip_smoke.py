#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, KBR training step and KBR training run, the
recipe families and the ResNet nets on one NVIDIA GPU (H100).

Phases, in order; any failure exits non-zero and prints no result:
1. device: require CUDA, print the card's name and power limit, pin exact
   float32 numerics (no TF32 in cuDNN convs or matmuls).
2. build: compile the port's CUDA kernels from `slowtv_monodepth_tpu_torch/csrc`.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the serving path's shapes (B=2), ragged shapes and the shapes
   two of the training run's augmentation buckets give it; times both. The
   fused ConvNeXt block (kernel 9) is held to its plain version in float64,
   erf and tanh, two calls bitwise equal, at the four ConvNeXt-B stage shapes
   and the four ConvNeXt-T ones of the pose net (B=8); timed at B=1 and B=4
   and at the KBR micro-step's 54 block shapes, there also split by CUDA
   launch (prep, fc1, fc2). The decoder stage (kernel 3) is held to the
   plain stage for ha, feat and disp, two calls bitwise equal (an unaligned
   x among the ragged shapes), timed per request at B=1, per forward at B=2
   and per micro-step (B=4), there also split by CUDA launch (conv_a,
   conv_b, disp).
4. golden: ConvNeXt-B + monodepth at full width with seeded weights
   (`models.seeded_state_dict`) against the JAX package's outputs stored in
   `tests/fixtures/torch_port_golden.npz`, with the ConvNeXt blocks unfused
   and again with `fused_blocks=True`.
5. slice: a reference-layout checkpoint of those weights with the KBR
   `net.depth` cfg -> `BenchmarkPredictor.load_model` -> `quickstart.predict`
   on 6 synthetic 384x640 scenes -> .npy files; asserts the outputs and the
   launch counts (36 dwconv + 2 decoder stages per request). Then the same
   through a second checkpoint whose cfg says `fused_blocks: True` (36 fused
   blocks, 0 dwconv, 2 decoder stages per request; the same maps; a forward
   under grad keeps its grad_fn). Times warm requests at B=1 and B=4 on the kernel
   path, with the fused blocks on, and on the plain path.
6. training kernels: the tap gradient (kernel 2), the decoder stage's
   backward (4), the warp on float32 (5) and on packed bfloat16 sources (6)
   and the photometric error forward and backward (7, 8) against their plain
   versions (in float64) at the training step's shapes (B=4, 384x640), ragged
   shapes and the run's shapes (two of its augmentation buckets, the warp also
   from 720x1280 sources at the coords the augmentation gives it); times
   kernel, plain and, where one PyTorch call computes the function, that call
   (float32). Kernel 6 is also held to kernel 5 on the
   widened source. Kernel 8 called twice must give the same bits, also at
   the edges of its tiles (h = 2, w = 2, C = 1, images two and three tiles
   wide), kernel 7's error map the bits the parent checkout gave
   (`PHOTO_FWD_SHA256`, `tools/photo_bench.fwd_digests`), kernel 8's dx
   and dy theirs (`PHOTO_BWD_SHA256`, `bwd_digests`), and kernels 5 and 6
   their out, ddx and ddy (`WARP_SHA256`, `tools/warp_bench.digests`).
   Kernel 1 at the step's eight block shapes (float64, timed per micro-step); kernels 2 (at
   the step's eight block shapes) and 4 called twice on the same inputs must give the same bits. The fused block's backward (kernel 10, with kernels 1 and 2
   finishing dx and the taps' gradient) at the eight block shapes of the
   step (ConvNeXt-B at B=4, ConvNeXt-T at B=8), ragged shapes, erf and tanh:
   each of its ten gradients within twice the plain float32 version's error
   against float64, two calls bitwise equal; timed beside the plain backward
   and the unfused block's backward.
7. training golden: one KBR micro-step at full width (ConvNeXt-B + ConvNeXt-T,
   B=2, 64x96) against the JAX package's loss, gradients and loss after one
   update, stored in `tests/fixtures/torch_train_golden.npz`
   (`slowtv_monodepth_tpu_torch/train_golden.py`).
8. training slice: `MonoDepthTrainer(cfg)` -> `parsers.make_optimizer(cfg,
   nets, steps_per_epoch, accumulate=2)` -> `make_step_fn` on the KBR cfg at
   full width, B=4, 384x640 (synthetic scenes, supports shifted by +-2 px, a
   fixed K), fused decoder stages on, 3 optimizer updates; asserts a finite
   loss, a finite non-zero gradient for every parameter of both nets and the
   launch counts of every micro-step (warp 1, photo_fwd 2, photo_bwd 1,
   dwconv 108, dwconv_dw 54, decoder_stage 2, decoder_stage_bwd 2), then
   times micro-steps on the kernel path and on the plain path
   (`kernels=False`) and reads the peak device memory.
9. train -> serve: the trained weights -> `core.save_checkpoint` ->
   `BenchmarkPredictor.load_model` -> one `quickstart.predict` request.
9b. fused training: the training golden again with `fused_blocks: True` on
   both nets, then the training slice with them (3 updates; every parameter's
   gradient; per micro-step convnext_block 54, convnext_block_bwd 54, dwconv
   54, dwconv_dw 54, warp 1, photo_fwd 2, photo_bwd 1, decoder_stage 2,
   decoder_stage_bwd 2), its peak device memory, and its micro-step timed
   beside the unfused one.
10. run: `MonoDepthLoop` on the KBR cfg at full width (aspect-ratio
   augmentation at p=0.7 towards 384x640, accumulate 2, batch 4) over an
   in-memory loader of synthetic 720x1280 scenes in the layout the port's
   `device_transform` SlowTV dataset ships: one epoch of 8 batches (4 updates,
   several augmentation buckets), validation, last/best checkpoints and
   markers; a second loop on the same directory resumes at epoch 1 with the
   update count continued; `last.ckpt` serves through `BenchmarkPredictor` and
   `quickstart.predict`. The loop is read as a user reads it: a scalar writer
   at `log_every_n_steps: 1` and the loop's own timer. Asserts every kernel's
   launch count over the epoch and prints the micro-step time per bucket and the epoch's wall time split
   into loader / place+derive / AR-aug / step / validation / checkpoint.
   Then one epoch at the recipe's own `trainer.matmul: 'high'` (TF32 matmuls)
   and one with `trainer.warp_bf16` (the packed warp once per micro-step,
   kernel 5 only from the augmentation), 24 batches each so that buckets repeat, after which the process-global
   matmul precision and `cudnn.benchmark` are put back and checked.
11. recipe: `cfg/kbr/default.yaml` as it stands, through its dataset section:
   `MonoDepthLoop` over a `ConcatDataLoader` of in-memory stand-ins for its three
   pack datasets in its key order (`PackLoader`: KITTI 376x1242 with sparse
   benchmark depth, MannequinChallenge and SlowTV 720x1280; the layouts the readers
   yield, held to them by `tests/test_torch_recipe.py`), one epoch of 6 micro-steps
   (3 updates) and a validation batch of each (192x640 for KITTI, 384x640). Asserts
   the launch counts (each KITTI batch's depth one more kernel 5 launch, at C = 1),
   the round robin (depth on batches 0 and 3 only), the train metrics (MAE, RMSE,
   LogSI, AbsRel, Acc) logged finite on the KITTI micro-steps and at validation, and
   the first KITTI micro-step's metrics within 1e-5 of a float64 numpy restatement;
   prints each micro-step's bucket, ms and loss. Kernels 3, 4, 5 (KITTI's images and
   its depth from 376x1242) and 7, 8 are also held to their plain versions at the
   bucket of its second KITTI batch (phases 3 and 6).
12. published run: the run phase's loop as `slowtv-train-torch` runs it, twice (synchronous
   then asynchronous checkpoints, `trainer.async_ckpt`), 2 epochs of 4 batches and a
   validation batch each: both encoders from seeded files in timm's layout under a
   temporary model root placed first in `paths.MODEL_ROOTS` (`convnext_base.npz`,
   `convnext_tiny.pth`, `head.*` included; every depth-encoder tensor must be the file's
   bitwise, the pose stem the 6-channel adaptation, every other pose tensor the file's),
   the image logger (`HeavyLogger(6, 2)`) after each epoch (its tags for the KBR cfg,
   every grid (1, 3, H, W) finite in [0, 1], the launches of its rerun: dwconv 54,
   decoder_stage 2, warp 1, photo_fwd 2), epoch 0's `last.ckpt`, written while epoch 1
   trains, bitwise the state at its save (optimizer moments included); prints the
   graft's time, the logger's seconds, the Checkpoint timer, fit wall and peak device
   memory of both runs.
13. optimizers: one update (two micro-steps) of the KBR step at B=4, 384x640 with each of
   adam, sgd, lamb, adabelief and rmsprop: a finite loss, every parameter moved (SGD:
   where lr times the gradient reaches half an ulp, as on the CPU), the card's update
   equal to the same optimizer's on CPU copies with the same gradients (1e-6 of each
   tensor's largest magnitude).
14. train_dev: `train_dev.DevLoop` (`slowtv-train-dev-torch`), 1 epoch x 2 batches.
15. eval: the evaluation chain as `slowtv-export-preds-torch` and
   `slowtv-eval-depth-torch` run it, on in-memory stand-ins of SYNS-Patches,
   KITTI and MannequinChallenge (`EvalStandIn`, 12 items each, at the
   predictor's shapes 192x640 and 384x640; targets at the sources' full size,
   376x1242, KITTI's drive sizes as an object array, 720x1280; held to the
   real datasets' layouts by `tests/test_torch_eval_api.py`): a seeded KBR
   checkpoint refused without its `finished` marker, then
   `export_preds.compute_preds` in batches of 12 (36 dwconv + 2 decoder_stage
   launches per forward) and a partial batch of 5, every map within
   GOLDEN_ATOL of the plain path; the SYNS stand-in through a `fused_blocks`
   checkpoint (36 convnext_block per forward); images/s and device ms per
   batch of 12. Then `MonoDepthEvaluator` with the args of `syns_test`,
   `kitti_eigen`, `kitti_eigen_benchmark` and `mc` in this process (which
   holds CUDA): a Pool of 8 (`EVAL_NPROC`), equal item by item to nproc=0 on the first items;
   the kernel and plain predictions' metrics; a perfect prediction (AbsRel <
   1e-6, F-Score (10) 100 less its 1e-5 guard); seconds per item of each
   metric family.
16. eval zero-shot: the same chain on stand-ins of DDAD, DIODE, NYUD-v2, Sintel and
   TUM-RGBD (12 items each, one batch of 12, at the predictor's shapes 416x640,
   480x640 and 288x640: stage-4 maps of 13, 15 and 9 rows; targets at the sources'
   full size, 1216x1936 at 5% valid, 768x1024, 480x640, 436x1024, 480x640): 36 dwconv
   + 2 decoder_stage launches per forward, every map within GOLDEN_ATOL of the plain
   path, the DDAD stand-in also through the `fused_blocks` checkpoint (36
   convnext_block per forward); `MonoDepthEvaluator` with the args of `ddad`,
   `diode_indoors`, `diode_outdoor`, `nyud` (its crop), `sintel` and `tum` in a Pool
   of 8, the first item in process family by family (timed) equal to the Pool's, and
   a median-aligned perfect prediction per cfg (AbsRel < 1e-6; F-Score (10) 100 where
   the cfg has K). Then `mapfree_preds.compute_preds` on a MapFreeReloc stand-in (16
   portrait 512x384 frames, one batch, the maps within GOLDEN_ATOL of the plain path;
   720x540 DPT targets made from the kernel path's own maps, affine in disparity): the
   PNGs it writes through `utils/png.py` into a temporary tree, read back here by a
   numpy PNG decoder (CRCs, IHDR, 720x540 uint16), every depth positive, within 1 mm
   of the host path on the same maps; their median relative error to the targets
   printed. Device ms per batch, images/s and seconds per item of each metric family.
17. families: DVSO as it stands (virtual stereo, no pose net, supports [0], `stereo_const`,
   inverted-berHu hints, Laplacian smoothness, `disp_occ`), Depth-Hints-MS (log-l1 hints
   behind the hint automask, supports [-1, 1, 0]), SfM-Learner (explainability masks,
   `disp_mask`) and Klodt (uncertainty masks), as `cfg/benchmark/default.yaml` + the
   family's file give them (`family_cfg`, the default's ResNet-18 pose net as published),
   at ConvNeXt-B, 4 scales, B=8, 192x640, `T_stereo` of both signs in a batch: one
   forward + backward each on the kernel path and on the plain path from the same seeded
   weights and batch, the loss, every gradient and every BatchNorm running statistic held
   to the plain path's (1e-5, 1e-3 of each tensor's largest; the gates' flips counted and
   bounded), the launches of each kernel per micro-step (`FAMILY_LAUNCHES`), device ms per
   micro-step. Then DVSO through `MonoDepthLoop`: 2 epochs of 2 batches over
   `StereoHintLoader` (stereo frames, `T_stereo`, hints and KITTI's sparse depth), its
   launches, `last.ckpt` (the 3-channel disparity head), a validation batch each epoch.
18. resnet: the ResNet and ResNeXt nets with their BatchNorm state (`phase_resnet`):
   Monodepth2-M as it stands (ConvNeXt-B depth net, ResNet-18 pose net),
   `abl_pretrained/resnet18` and `abl_pretrained/resnext101_pt_ssl` (`resnet_cfg`; no
   weight file: the pretrained nets warn and keep the seeded weights), B=8, 192x640: one
   forward + backward each on the kernel and plain paths, held as in phase 17, the
   launches per micro-step (`RESNET_LAUNCHES`: a ResNet depth net fuses only decoder stage
   0), device ms per micro-step and peak memory. Then `abl_pretrained/resnet18` through
   `MonoDepthLoop` (2 epochs of 2 batches over `PackLoader` stand-ins of KITTI, a
   validation batch each), its `last.ckpt` with every running statistic and int64 counter
   equal to the trainer's, served by `BenchmarkPredictor` at B=12 in eval mode and held to
   the trainer's eval-mode forward (GOLDEN_ATOL).
   Alone: `python3 -c 'import chip_smoke as c; s = c.phase_device(); c.phase_build();
   c.phase_resnet(c._make_scenes(), s)'`.
Every time is a device time (`cuda_ms`: the calls captured into one CUDA
graph, CUDA events around one replay) with the eager time beside it. The last
two lines are a JSON object per kernel and the contract line
`{"ok": true, "device": {...}}`.

Usage: python3 chip_smoke.py   (from the repo root, one CUDA card)
"""
from __future__ import annotations

import contextlib
import functools
import gc
import importlib.util
import io
import json
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / 'tests' / 'fixtures' / 'torch_port_golden.npz'
KBR_DEPTH_CFG = {  # cfg/kbr/default.yaml, net.depth (no yaml on the card)
    'enc_name': 'convnext_base', 'pretrained': True, 'dec_name': 'monodepth',
    'out_scales': [0, 1, 2, 3], 'use_virtual_stereo': False,
    'mask_name': None, 'num_ch_mask': None, 'use_stereo_blend': False}
KBR_TRAINER_CFG = {'min_depth': 0.1, 'max_depth': 100}
KBR_TRAIN_CFG = {  # cfg/kbr/default.yaml: nets, losses, optimizer, scheduler, trainer
    'net': {'depth': KBR_DEPTH_CFG,
            'pose': {'enc_name': 'convnext_tiny', 'pretrained': True, 'learn_K': True}},
    'loss': {'img_recon': {'weight': 1, 'use_min': True, 'use_automask': True},
             'disp_smooth': {'weight': 0.001, 'use_edges': True, 'use_laplacian': False,
                             'use_blur': False}},
    'optimizer': {'type': 'adamw', 'lr': 0.0001, 'weight_decay': 0.001},
    'scheduler': {'steplr': {'step_size': 40, 'gamma': 0.1},
                  'linear': {'start_factor': 0.1, 'total_iters': 4}},
    'trainer': {**KBR_TRAINER_CFG, 'accumulate_grad_batches': 2, 'always_fwd_pose': False,
                'precision': 32}}
SUPP_IDXS = (-1, 1)
TRAIN_B = 4
TRAIN_UPDATES = 3
# Kernel launches per micro-step of the KBR step: one batched warp over the
# (2 supports x 4 scales x B) stack, the photometric error on that stack and
# on the untiled static (automask) stack, one backward (the static error
# needs none), 54 ConvNeXt blocks (36 depth + 18 pose) each with a forward
# and an input-gradient dwconv launch and a tap gradient, the two fused
# decoder stages forward and backward.
TRAIN_LAUNCHES = {'dwconv': 108, 'decoder_stage': 2, 'decoder_stage_bwd': 2, 'dwconv_dw': 54,
                  'warp': 1, 'warp_packed': 0, 'photo_fwd': 2, 'photo_bwd': 1,
                  'convnext_block': 0,  # training builds its nets with the blocks unfused
                  'convnext_block_bwd': 0}
# With `fused_blocks: True` on both nets: each of the 54 blocks one forward
# launch (kernel 9) and one backward (kernel 10, then kernel 1 for dx and
# kernel 2 for the taps' gradient).
FUSED_TRAIN_LAUNCHES = {**TRAIN_LAUNCHES, 'dwconv': 54, 'convnext_block': 54,
                        'convnext_block_bwd': 54}
# The run phase: cfg/kbr/default.yaml's trainer section (its `matmul: 'high'`
# is run as well; the first run pins 'highest', the numerics of every other phase).
RUN_SEED = 42
RUN_BATCHES = 8        # the asserted epochs: 4 updates
RUN_LONG_BATCHES = 24  # the two timing epochs: most buckets come up more than once
RUN_SRC_SHAPE = (720, 1280)   # SlowTV's native frames
RUN_CFG = {**KBR_TRAIN_CFG, 'seed': RUN_SEED, 'trainer': {
    **KBR_TRAIN_CFG['trainer'], 'max_epochs': 1, 'resume_training': True, 'load_ckpt': None,
    'log_every_n_steps': 1, 'monitor': 'loss', 'aspect_ratio_aug_prob': 0.7,
    'aspect_ratio_ref_shape': [384, 640], 'gradient_clip_val': None, 'benchmark': True,
    'matmul': 'highest', 'swa': None, 'early_stopping': None}}
# Published peaks of one H100 SXM at 700 W: float32 outside the tensor cores, HBM3.
# Two of the centre crops that the run's first epoch draws (seed 42): every kernel
# is also held against its plain version at the shapes these buckets give it.
RUN_CROPS = ((345, 1141), (620, 496))   # -> buckets 224x832 and 480x384
# The recipe phase: cfg/kbr/default.yaml's dataset section at its published shapes, per
# dataset (train source shape, val shape). KITTI's batches carry its benchmark depth, read
# at `KittiRawDataset.SHAPE` in every mode, sparse: about 5% of the pixels valid, in [1, 80] m.
RECIPE_DATASETS = {'kitti_lmdb': ((376, 1242), (192, 640)),
                   'mannequin_lmdb': ((720, 1280), (384, 640)),
                   'slow_tv_lmdb': ((720, 1280), (384, 640))}
RECIPE_DEPTH_SHAPE = (376, 1242)
RECIPE_DEPTH_VALID = 0.05
RECIPE_TRAIN_BATCHES = 2   # per dataset: 6 micro-steps in the round robin, 3 updates
# The centre crop of the recipe phase's second KITTI batch (seed 42, epoch 0): kernels 3, 4,
# 5 (on KITTI's images and its depth), 7 and 8 are also held at the shapes its bucket gives.
RECIPE_KITTI_CROP = (220, 342)   # -> bucket 320x544
# The published run (pretrained encoders, image logger, asynchronous saves): epochs of
# A7B_BATCHES micro-steps (2 updates) and a validation batch each.
A7B_EPOCHS, A7B_BATCHES = 2, 4
# The image logger's rerun of the KBR loss on the epoch's last batch: one eval forward of
# both nets (36 + 18 blocks), the two fused decoder stages, the batched warp and the
# photometric error on the warped and the static stacks; no backward.
RERUN_LAUNCHES = {'dwconv': 54, 'decoder_stage': 2, 'warp': 1, 'photo_fwd': 2}
# Its grids for the KBR cfg on batches without a depth target (prefixed `train_`).
HEAVY_TAGS = {'imgs_aug/target', 'imgs_aug/supp_-1', 'imgs_aug/supp_1', 'imgs/target',
              'imgs/supp_-1', 'imgs/supp_1', 'pred/disp', 'pred/feats', 'loss/warp_-1',
              'loss/warp_1', 'loss/automask', 'loss/disp_grad', 'loss/image_grad'}
# The other optimizers the JAX package builds (optax's options), one update each; the
# card's update against the same optimizer on CPU copies, relative to each tensor's
# largest magnitude (a float32 ulp there is 6e-8; foreach kernels round alike).
OPTIMIZER_CFGS = {'adam': {'type': 'adam', 'lr': 1e-4},
                  'sgd': {'type': 'sgd', 'lr': 1e-2, 'momentum': 0.9, 'nesterov': True},
                  'lamb': {'type': 'lamb', 'lr': 1e-4, 'weight_decay': 1e-3},
                  'adabelief': {'type': 'adabelief', 'lr': 1e-4},
                  'rmsprop': {'type': 'rmsprop', 'lr': 1e-4, 'centered': True, 'momentum': 0.9}}
OPT_RTOL = 1e-6
# The recipe phase's train metrics on a KITTI micro-step against a float64 numpy restatement.
METRICS_RTOL = 1e-5
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
CONVNEXT_B_BLOCKS = (3, 3, 27, 3)
# (b, h, w, c, blocks) of every block shape of the KBR micro-step at B=4, 384x640:
# ConvNeXt-B on the 4 images, ConvNeXt-T on the 2 x 4 image pairs.
STEP_BLOCKS = [(4, 96, 160, 128, 3), (4, 48, 80, 256, 3), (4, 24, 40, 512, 27),
               (4, 12, 20, 1024, 3), (8, 96, 160, 96, 3), (8, 48, 80, 192, 3),
               (8, 24, 40, 384, 9), (8, 12, 20, 768, 3)]
# Tolerances (float32 on both sides, sums taken in another order):
DWCONV_ATOL = 1e-5   # 49-tap sums of O(1) values (measured ~1.4e-6)
STAGE_ATOL = 1e-5    # 9*ci-term sums (ci <= 64) through ELU, sigmoid (~2.5e-6)
GOLDEN_ATOL = 1e-5   # 36 blocks + decoder vs the JAX package on the CPU (~8e-7)
# The fused ConvNeXt block against its plain version in float64, relative to
# max|y|: two float32 FMA chains of C and 4C <= 4096 O(1) terms each, summed in
# another order (measured ~5e-7; the plain version in float32 sits at ~1e-6).
BLOCK_RTOL = 5e-6
# Against the plain version in float64:
DW_ATOL = 1e-5       # tap gradient, normalized to O(1) taps; sums over b*h*w terms
# 4-corner bilinear of values in [0, 1]; a source of larger values (KITTI's benchmark
# depth, up to 80 m) is held to WARP_ATOL times its max|value|.
WARP_ATOL = 1e-5
# The stage's backward, each gradient relative to its own largest magnitude
# (a gradient that is exactly zero must come out exactly zero): 1e-5 for dx,
# and for the weight and bias gradients (sums over P = b*2h*2w pixels)
# 1e-5 * max(1, sqrt(P) / 16).
STAGE_BWD_RTOL = 1e-5
# The fused block's backward (kernel 10 + kernels 1 and 2) against float64, each
# gradient relative to its own largest magnitude: at most twice the plain
# float32 version's error; at the ragged shapes only (35 pixels and fewer,
# where both sit within a few float32 ulps of float64 and their ratio is
# chance) twice that plus four ulps (2^-24 each) of the largest magnitude.
BLOCK_BWD_FLOOR = 4 * 2.0 ** -24
BF16_LOSS_RTOL = 5e-3  # first-step loss, bfloat16 warp sources (8 mantissa bits) vs float32
# The photometric error's statistics are variances by cancellation,
# P(x^2) - P(x)^2, as in the reference: in float32 on smooth image regions
# (a sky) they carry ~1e-7 absolute error against c2 = 9e-4, so the map and
# its gradient are good to ~1e-4 there. The kernel (float32) is held to
# twice the plain version's own float32 error against float64, plus:
PHOTO_ATOL = 1e-5      # of the error map (in [0, 1])
PHOTO_BWD_RTOL = 1e-5  # of the largest |gradient|
EVAL_ITEMS = 12         # per evaluation stand-in: one batch; keeps the whole script near 600 s
EVAL_BATCH = 12         # `export_preds`' batch size
EVAL_PARTIAL = 17       # one more SYNS export: a batch of 12 and a partial one of 5
EVAL_NPROC = 8          # the evaluator's Pool: one worker per core of the card's machine
EVAL_SERIAL_ITEMS = 1   # nproc=0 over the first item, held to the Pool's metrics of it
EVAL_PLAIN_ITEMS = 4    # items also evaluated from the plain path's predictions
EVAL_THRESHOLDED = ('delta', 'F-Score', 'IoU', 'Dir')  # step functions of the pixels
EVAL_SETS = {  # stand-in -> (source shapes, cycled over the items; target densities per cfg)
    'syns_patches': (((376, 1242),), {'syns_test': 0.7}),
    'kitti': (((375, 1242), (370, 1224), (374, 1238), (376, 1241)),  # KITTI's drive sizes
              {'kitti_eigen': 0.04, 'kitti_eigen_benchmark': 0.15}),  # raw velodyne, benchmark
    'mannequin': (((720, 1280),), {'mc': 0.5}),
    # Phase 16 (zero-shot): each dataset's SHAPE; DDAD's LiDAR sparse, DIODE's valid mask
    'ddad': (((1216, 1936),), {'ddad': 0.05}),
    'diode': (((768, 1024),), {'diode_indoors': 0.9, 'diode_outdoor': 0.9}),
    'nyud': (((480, 640),), {'nyud': 1.0}),
    'sintel': (((436, 1024),), {'sintel': 1.0}),
    'tum': (((480, 640),), {'tum': 0.8})}
EVAL_A8A_SETS = ('syns_patches', 'kitti', 'mannequin')  # phase 15's
ZERO_SHOT_SETS = ('ddad', 'diode', 'nyud', 'sintel', 'tum')  # phase 16's
NO_K_CFGS = ('diode_indoors', 'diode_outdoor', 'nyud', 'tum')  # their datasets have no K
EVAL_ARGS = {  # cfg/eval/<name>.yaml `args` (no yaml on the card)
    'syns_test': {'min': 0.001, 'max': 100, 'use_eigen_crop': False,
                  'metrics': ['eigen', 'benchmark', 'pointcloud', 'ibims']},
    'kitti_eigen': {'min': 0.001, 'max': 80, 'use_eigen_crop': True,
                    'metrics': ['eigen', 'pointcloud']},
    'kitti_eigen_benchmark': {'min': 0.001, 'max': 100, 'use_eigen_crop': False,
                              'metrics': ['eigen', 'benchmark', 'pointcloud']},
    'mc': {'min': 0.001, 'max': 100, 'use_eigen_crop': False,
           'metrics': ['eigen', 'benchmark', 'pointcloud']},
    'ddad': {'min': 0.001, 'max': 250, 'use_eigen_crop': False,
             'metrics': ['eigen', 'benchmark', 'pointcloud']},
    'diode_indoors': {'min': 0.001, 'max': 150, 'use_eigen_crop': False,
                      'metrics': ['eigen', 'benchmark']},
    'diode_outdoor': {'min': 0.001, 'max': 150, 'use_eigen_crop': False,
                      'metrics': ['eigen', 'benchmark']},
    'nyud': {'min': 0.001, 'max': 100, 'use_eigen_crop': False, 'use_nyud_crop': True,
             'metrics': ['eigen', 'benchmark']},
    'sintel': {'min': 0.001, 'max': 100, 'use_eigen_crop': False,
               'metrics': ['eigen', 'benchmark', 'pointcloud']},
    'tum': {'min': 0.001, 'max': 100, 'use_eigen_crop': False,
            'metrics': ['eigen', 'benchmark']}}
EVAL_ALIGN = 'lsqr'     # `slowtv-eval-depth-torch`'s default
# Phase 17: the recipe families beside KBR, as `cfg/benchmark/default.yaml` + the family's
# file merge them (no yaml on the card; `tests/test_torch_families.py` holds these to the
# files), with the default's ResNet-18 pose net as published.
BENCH_DEFAULT_CFG = {
    'net': {'depth': {'enc_name': 'convnext_base', 'pretrained': True, 'dec_name': 'monodepth',
                      'out_scales': [0, 1, 2, 3], 'use_virtual_stereo': False, 'mask_name': None,
                      'num_ch_mask': None, 'use_stereo_blend': False},
            'pose': {'enc_name': 'resnet18', 'pretrained': True}},
    'loss': {'img_recon': {'weight': 1, 'use_min': False, 'use_automask': False},
             'disp_smooth': {'weight': 0.001, 'use_edges': True, 'use_laplacian': False,
                             'use_blur': False}},
    'dataset': {'kitti_lmdb': {
        'split': 'eigen_zhou', 'shape': [192, 640],
        'train': {'mode': 'train', 'datum': 'image support depth_velo K', 'use_aug': True},
        'val': {'mode': 'test', 'datum': 'image support depth K', 'use_aug': False}}},
    'loader': {'batch_size': 8, 'num_workers': 8, 'drop_last': True, 'train': {'shuffle': True},
               'val': {'shuffle': False}},
    'optimizer': {'type': 'adam', 'lr': 0.0001},
    'scheduler': {'steplr': {'step_size': 15, 'gamma': 0.1}},
    'trainer': {'max_epochs': 30, 'resume_training': True, 'load_ckpt': None,
                'log_every_n_steps': 100, 'monitor': 'AbsRel', 'gradient_clip_val': None,
                'accumulate_grad_batches': 1, 'logger': 'tensorboard'}}
_HINT_DATUM = {'train': {'datum': 'image support depth_velo depth_hint K'},
               'val': {'datum': 'image support depth depth_hint K'}}
FAMILY_FILE_CFGS = {  # cfg/benchmark/<name>.yaml
    'dvso': {'net': {'depth': {'use_virtual_stereo': True}, 'pose': None},
             'loss': {'stereo_const': {'weight': 1, 'loss_name': 'l1'},
                      'depth_regr': {'weight': 10, 'loss_name': 'berhu', 'use_automask': False,
                                     'invert': True},
                      'disp_smooth': {'use_laplacian': True}, 'disp_occ': {'weight': 0.01}},
             'dataset': {'kitti_lmdb': {'supp_idxs': [0], **_HINT_DATUM}}},
    'depth_hints_MS': {'loss': {'img_recon': {'use_min': True, 'use_automask': True},
                                'depth_regr': {'weight': 1, 'loss_name': 'log_l1',
                                               'use_automask': True}},
                       'dataset': {'kitti_lmdb': {'supp_idxs': [-1, 1, 0], **_HINT_DATUM}}},
    'sfm_learner': {'net': {'depth': {'mask_name': 'explainability', 'num_ch_mask': 2}},
                    'loss': {'img_recon': {'mask_name': 'explainability'},
                             'disp_mask': {'weight': 0.2}},
                    'dataset': {'kitti_lmdb': {'supp_idxs': [-1, 1]}}},
    'klodt': {'net': {'depth': {'mask_name': 'uncertainty', 'num_ch_mask': 2}},
              'loss': {'img_recon': {'mask_name': 'uncertainty'}},
              'dataset': {'kitti_lmdb': {'supp_idxs': [-1, 1]}}}}
FAMILY_B, FAMILY_SHAPE = 8, (192, 640)   # the cfgs' batch and KITTI shape
# Kernel launches per micro-step (forward + backward) of each family at 4 scales:
# - dwconv 2 per ConvNeXt block (forward, and dx with flipped taps), dwconv_dw 1: the 36
#   blocks of ConvNeXt-B (the ResNet-18 pose net's convs, BatchNorm and max-pool are cuDNN's);
# - decoder_stage / _bwd: the disparity decoder's two fused stages where it has one output
#   channel; virtual stereo (3 channels) and the mask decoder (num_ch_mask) run unfused
#   stages, as the JAX package's, so DVSO launches none and the mask families 2;
# - warp: one batched view synthesis per handler call: DVSO the image reconstruction, its
#   stereo view's and `stereo_const` (disparities, C = 1); Depth-Hints the reconstruction
#   and the hint automask's two; the mask families the reconstruction;
# - photo_fwd: each `compute_photo` (DVSO: both views; Depth-Hints: the reconstruction, its
#   static automask error and the hint automask's two, those three under no_grad); photo_bwd:
#   the reconstructions with a gradient.
_FAMILY_ZERO = {'warp_packed': 0, 'convnext_block': 0, 'convnext_block_bwd': 0}
FAMILY_LAUNCHES = {
    'dvso': {'dwconv': 72, 'dwconv_dw': 36, 'decoder_stage': 0, 'decoder_stage_bwd': 0,
             'warp': 3, 'photo_fwd': 2, 'photo_bwd': 2, **_FAMILY_ZERO},
    'depth_hints_MS': {'dwconv': 72, 'dwconv_dw': 36, 'decoder_stage': 2, 'decoder_stage_bwd': 2,
                       'warp': 3, 'photo_fwd': 4, 'photo_bwd': 1, **_FAMILY_ZERO},
    'sfm_learner': {'dwconv': 72, 'dwconv_dw': 36, 'decoder_stage': 2, 'decoder_stage_bwd': 2,
                    'warp': 1, 'photo_fwd': 1, 'photo_bwd': 1, **_FAMILY_ZERO}}
FAMILY_LAUNCHES['klodt'] = FAMILY_LAUNCHES['sfm_learner']
# DVSO's validation step: the forward and the loss under no_grad.
FAMILY_VAL_LAUNCHES = {'dwconv': 36, 'warp': 3, 'photo_fwd': 2}
# A binary gate with no tie-break (the Depth-Hints automask; the image automask's eps
# tie-break): the kernel and plain paths compute the compared errors in another float32
# order, so bits within that agreement of a tie may flip. At most this share of them;
# where any flips, the family's `loss_depth_regr` and total are held at FAMILY_GATE_RTOL
# (one flipped pixel moves the masked mean by ~1/valid pixels), the pose net's gradients at
# FAMILY_GATE_POSE_RTOL of each tensor's largest magnitude and the depth net's gradient as
# one vector at FAMILY_GATE_DEPTH_L2 relative L2 (the CPU test's measured flip effects:
# 1.6e-3 and 3.3e-2, tests/test_torch_families_trajectory.py).
FAMILY_GATE_SHARE = 1e-3
FAMILY_GATE_RTOL, FAMILY_GATE_POSE_RTOL, FAMILY_GATE_DEPTH_L2 = 5e-3, 1e-2, 1e-1
FAMILY_RUN_BATCHES, FAMILY_RUN_EPOCHS = 2, 2   # the DVSO loop: 2 epochs of 2 batches
# BatchNorm's running statistics after one train-mode pass, kernel path against plain path,
# relative to each tensor's largest value: the same cuDNN convs on both paths, the depth
# net's skip features those of the same encoder.
BN_STATS_RTOL = 1e-3
# Phase 18: the ResNet and ResNeXt nets, as `cfg/benchmark/default.yaml`, then (for
# `cfg/abl_pretrained/`) that directory's `default.yaml`, then the file merge them (no yaml on
# the card; `tests/test_torch_families.py` holds these to the files).
_ABL_PRETRAINED_DEFAULT = {'loss': {'img_recon': {'use_min': True, 'use_automask': True}},
                           'dataset': {'kitti_lmdb': {'supp_idxs': [-1, 1]}}}
RESNET_FILE_CFGS = {  # cfg name -> the files merged over `BENCH_DEFAULT_CFG`, in order
    'benchmark/monodepth2_M': [{'loss': {'img_recon': {'use_min': True, 'use_automask': True}},
                                'dataset': {'kitti_lmdb': {'supp_idxs': [-1, 1]}}}],
    'abl_pretrained/resnet18': [_ABL_PRETRAINED_DEFAULT,
                                {'net': {'depth': {'enc_name': 'resnet18', 'pretrained': False}}}],
    'abl_pretrained/resnext101_pt_ssl': [
        _ABL_PRETRAINED_DEFAULT,
        {'net': {'depth': {'enc_name': 'ssl_resnext101_32x8d', 'pretrained': True}}}]}
# Kernel launches per micro-step (forward + backward), min-reprojection + automask as the KBR
# step: one batched warp, the photometric error on the warped and the static stacks, one
# backward. ConvNeXt-B's 36 blocks in Monodepth2-M's depth net: dwconv 72, dwconv_dw 36, its
# decoder's stages 1 and 0 fused. A ResNet depth net has features at stride 2, so stage 1
# takes a skip and only stage 0 is fused; no dwconv. The ResNet-18 pose net launches none.
_RESNET_LOSS_LAUNCHES = {'warp': 1, 'photo_fwd': 2, 'photo_bwd': 1, **_FAMILY_ZERO}
RESNET_LAUNCHES = {
    'benchmark/monodepth2_M': {'dwconv': 72, 'dwconv_dw': 36, 'decoder_stage': 2,
                               'decoder_stage_bwd': 2, **_RESNET_LOSS_LAUNCHES},
    'abl_pretrained/resnet18': {'dwconv': 0, 'dwconv_dw': 0, 'decoder_stage': 1,
                                'decoder_stage_bwd': 1, **_RESNET_LOSS_LAUNCHES}}
RESNET_LAUNCHES['abl_pretrained/resnext101_pt_ssl'] = RESNET_LAUNCHES['abl_pretrained/resnet18']
RESNET_RUN = 'abl_pretrained/resnet18'   # train -> checkpoint -> serve
RESNET_SERVE_B = 12                      # `export_preds`' batch
# Kernel 7's map at the KBR step's two photometric shapes on
# `tools/photo_bench.digest_inputs`, as its parent checkout (f3a8e85) gave it on an
# H100: separating kernel 8 out of csrc/photo.cu left kernel 7's bits alone.
PHOTO_FWD_SHA256 = {
    '(32, 384, 640, 3)': '8a7043fe5d1e0bb8469633ff36f6f3fe51efb2eac9c49f8a25029d6043aef40b',
    '(8, 384, 640, 3)': 'd2dd0378e18652077e764e20c8ef8d79e8283778e231c3f38453b7a3def10000'}
# Kernels 5 and 6's out, ddx and ddy on `tools/warp_bench.digest_inputs` (the
# step's stack at near-identity coords, the supports' resample onto 224x832;
# kernel 6 on the source rounded to bfloat16), as the parent checkout of their
# redesign (72d0ae1) gave them on an H100: the redesign kept blend's bits.
WARP_SHA256 = {
    'warp step out': '307aa3be8ea2dccd776e5bc20627ef4ceeda6819d2b4b5a4d5eb1b61837b20ae',
    'warp step ddx': '9351deca7fdb796dc17517f291e529c24ddb433725b49856e24d74c0a4309aee',
    'warp step ddy': 'd8413351974e8bb855f54733793202ab3cf941cb343353075535bfaa5d198946',
    'warp_packed step out': '08b0428dadf9fe08d7cfc96daa9685035bddf386f098146c8b8784cbc4d5706f',
    'warp_packed step ddx': 'e380a459c7b18f8c96f8577b8b3a4a2cd4d97bc51391a9494f1351b897132879',
    'warp_packed step ddy': '4a8b8a96bd779284ad383c3e66d31e0cd87eb593674e7709fbccfbf96490ca7f',
    'warp resample out': 'a92e4ac05b39632004f699a13587e187e11555cdb42dc359f630d77b3c025fa1',
    'warp resample ddx': 'c25786806a189160020fb241da24d4807a430abde943992cfeff6b84e01b979e',
    'warp resample ddy': 'aba6b2379984c6948d35aedd191f00215712fde153cc5c4e69fdd06af1704392',
    'warp_packed resample out': '4fb0957c6d60635b99a130f21ad285dd9ea54e63999fee0b833360f963f5ec75',
    'warp_packed resample ddx': 'fee06b20cda9544392d567b2d543ab72aec804f413a09cfb3bf22809fd30a804',
    'warp_packed resample ddy': 'b0889fcbbf8f65c94993f145c2cff1c3816fcd0995cf453bdd618e1a66ae89e8'}
# Kernel 8's dx and dy at (32, 384, 640, 3) on the same inputs, as its parent
# checkout (2e67e19) gave them on an H100: moving its row staging and rounded
# operations into csrc/photo_common.cuh left its bits alone.
PHOTO_BWD_SHA256 = {
    'dx': '3c382221880e7ba5850843d4656af5d4382b35662edf15691349e5b1ca4242d3',
    'dy': '3882c16cd110b8bb0ef8ad0cdd978fe395984b614db9d76777175272b5a2c416'}


def fail(msg: str) -> None:
    raise SystemExit(f'chip_smoke FAILED: {msg}')


_TIMING_STREAM = None


def timing_stream() -> torch.cuda.Stream:
    """The one stream every timed call runs on, eager, captured and replayed.
    A forward whose backward is timed is run on it too: autograd runs each
    backward op on its forward op's stream, and a capture sees that stream only."""
    global _TIMING_STREAM
    if _TIMING_STREAM is None:
        _TIMING_STREAM = torch.cuda.Stream()
    return _TIMING_STREAM


class Timing(NamedTuple):
    ms: float        # device time per call: one CUDA-graph replay of `iters` calls / iters
    eager_ms: float  # CUDA events around `iters` eager calls / iters: adds the host's dispatch
    how: str         # 'graph', or 'profiler' where the calls could not be captured


def _profiler_ms(fn, iters: int) -> float:
    """Device time per call of `fn` from `torch.profiler`'s sum over its CUDA kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> Timing:
    """Device and eager time of `fn()` in ms per call.

    Device: `iters` calls captured into one CUDA graph, CUDA events around one
    replay (after a first one), divided by `iters`: the host's dispatch
    (argument checks, autograd, ctypes) is not in it. Eager: CUDA events
    around `iters` calls made from Python, as a caller makes them.
    """
    s = timing_stream()
    s.wait_stream(torch.cuda.current_stream())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(s):
        for _ in range(warmup):
            fn()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        eager = start.elapsed_time(end) / iters
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=s):
                for _ in range(iters):
                    fn()
        except RuntimeError as e:
            del graph
            torch.cuda.synchronize()
            ms = _profiler_ms(fn, iters)
            print(f'  (not capturable, timed by torch.profiler: {str(e).splitlines()[0][:120]})')
            return Timing(ms, eager, 'profiler')
        graph.replay()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
    del graph
    return Timing(ms, eager, 'graph')


@contextlib.contextmanager
def on_timing_stream():
    """Run the body on `timing_stream()`, after the work queued so far."""
    s = timing_stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        yield


def bound_ms(n_bytes: float, flops: float) -> tuple[float, float]:
    """(ms to move `n_bytes` at the card's memory rate, ms for `flops` float32
    operations at its peak rate); the larger is the least time the card could take."""
    return 1e3 * n_bytes / PEAK_BYTES, 1e3 * flops / PEAK_F32_FLOPS


def new_result() -> dict:
    return {'err': 0.0, 'ms': 0.0, 'plain_ms': 0.0, 'library_ms': None, 'bound_ms': 0.0,
            'bound_bytes_ms': 0.0, 'bound_ops_ms': 0.0, 'eager_ms': 0.0, 'plain_eager_ms': 0.0,
            'library_eager_ms': None, 'timed_by': 'graph'}


def add_times(r: dict, n: int, t: Timing, plain: Timing, bound: tuple, library=None) -> str:
    """Add `n` launches' times per main path to a kernel's result -> text for the log:
    device times, eager times in brackets."""
    r['ms'] += n * t.ms
    r['plain_ms'] += n * plain.ms
    r['eager_ms'] += n * t.eager_ms
    r['plain_eager_ms'] += n * plain.eager_ms
    r['bound_ms'] += n * max(bound)
    r['bound_bytes_ms'] += n * bound[0]
    r['bound_ops_ms'] += n * bound[1]
    if 'profiler' in (t.how, plain.how) + (() if library is None else (library.how,)):
        r['timed_by'] = 'profiler for some calls'
    text = (f'; device ms (eager): kernel {t.ms:.4f} ({t.eager_ms:.4f}), plain {plain.ms:.4f} '
            f'({plain.eager_ms:.4f}), bound {max(bound):.4f} '
            f'({"bytes" if bound[0] >= bound[1] else "operations"})')
    if library is not None:
        r['library_ms'] = (r['library_ms'] or 0.0) + n * library.ms
        r['library_eager_ms'] = (r['library_eager_ms'] or 0.0) + n * library.eager_ms
        text += f', library {library.ms:.4f} ({library.eager_ms:.4f})'
    return text + f', x{n} per main path'


def run_buckets() -> list[tuple[tuple[int, int], tuple[int, int]]]:
    """(crop, bucket shape) of `RUN_CROPS` under the run's augmentation settings."""
    from slowtv_monodepth_tpu_torch.core.aspect_ratio import sample_resize
    ref = RUN_CFG['trainer']['aspect_ratio_ref_shape']
    return [(crop, sample_resize(crop, ref, eps=0.8)) for crop in RUN_CROPS]


def kitti_bucket() -> tuple[tuple[int, int], tuple[int, int]]:
    """(crop, bucket shape) of `RECIPE_KITTI_CROP` under the run's augmentation settings."""
    from slowtv_monodepth_tpu_torch.core.aspect_ratio import sample_resize
    return RECIPE_KITTI_CROP, sample_resize(RECIPE_KITTI_CROP,
                                            RUN_CFG['trainer']['aspect_ratio_ref_shape'], eps=0.8)


def sparse_depth(rs, b: int) -> np.ndarray:
    """(b, *RECIPE_DEPTH_SHAPE, 1) float32 benchmark-style depth: `RECIPE_DEPTH_VALID`
    of the pixels in [1, 80] m, the rest 0 (no measurement)."""
    valid = rs.rand(b, *RECIPE_DEPTH_SHAPE, 1) < RECIPE_DEPTH_VALID
    return np.where(valid, rs.uniform(1, 80, valid.shape), 0).astype(np.float32)


def stage_cost(b, h, w, ci, cd, backward: bool, taps9: bool = False) -> tuple[float, float]:
    """(bytes, float32 operations) of one decoder stage, forward or backward.
    The forward's conv_b counts as kernel 3 computes it, four pre-summed taps
    per output (16 CD x CD products per ha pixel), or with `taps9` as nine taps
    on the upsampled grid (36)."""
    p = b * h * w
    conv_flops = 2 * 9 * (ci * cd * p + cd * cd * 4 * p + cd * 4 * p)
    params = 9 * (ci * cd + cd * cd + cd) + 2 * cd + 1
    x, ha, feat, disp = p * ci, p * cd, 4 * p * cd, 4 * p
    if not backward:  # reads x and the parameters, writes feat and disp
        presum = 0 if taps9 else 2 * 16 * cd * cd * p - 2 * 9 * cd * cd * 4 * p
        return 4 * (x + params + feat + disp), conv_flops + presum
    # reads x, the weights, ha, feat, disp and both cotangents; writes seven gradients;
    # each conv has an input and a weight gradient of the forward's cost each, but the
    # input gradient through the upsample: 16 pre-summed taps (cd x cd) per ha pixel.
    up_grad = 2 * 16 * cd * cd * p - 2 * 9 * cd * cd * 4 * p
    return 4 * (x + params + ha + 2 * feat + 2 * disp + x + params), 2 * conv_flops + up_grad


# ---------------------------------------------------------------- phases
def phase_device() -> str:
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this script needs a CUDA card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f'torch {torch.__version__} cuda {torch.version.cuda}; '
          f'{torch.cuda.device_count()} device(s); using {torch.cuda.get_device_name(0)}')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    print('numerics: torch.backends.cudnn.allow_tf32=False, '
          "float32 matmul precision 'highest' (exact float32) for every phase")
    return smi


def phase_build() -> None:
    import slowtv_monodepth_tpu_torch
    from slowtv_monodepth_tpu_torch import _build
    pkg = Path(slowtv_monodepth_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        fail(f'imported the port from {pkg}, not from this checkout ({ROOT})')
    b = _build.build()
    _build.load()
    print(f'build: {b.path.relative_to(ROOT)} '
          f'({"nvcc " + format(b.seconds, ".1f") + " s" if b.seconds else "already built"})')
    log = b.log or b.path.with_suffix('.log').read_text()
    entry = ''
    for line in log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
            print(f'  {line.strip()}')
        if 'Compiling entry' in line:
            entry = line
        if 'convnext_block_fwd_' in entry and 'spill' in line \
                and '0 bytes spill stores, 0 bytes spill loads' not in line:
            fail(f'a launch of the fused ConvNeXt block kernel spills registers: {line.strip()}')
        if 'decoder_stage_fwd_' in entry and 'stack frame' in line \
                and '0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads' not in line:
            fail(f'a launch of the decoder-stage kernel uses local memory: {line.strip()}')
        if ('photo_bwd_kernel' in entry or 'photo_fwd_kernel' in entry) and 'stack frame' in line \
                and '0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads' not in line:
            fail(f'a launch of a photometric kernel uses local memory: {line.strip()}')
        if 'warp_bilinear_kernel' in entry and 'stack frame' in line \
                and '0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads' not in line:
            fail(f'a launch of the warp kernel uses local memory: {line.strip()}')
        # Kernel 3's launches run two 256-thread blocks an SM only within 128 registers.
        if 'decoder_stage_fwd_' in entry and 'registers' in line \
                and int(line.split('Used ')[1].split()[0]) > 128:
            print(f'  NOTE: over 128 registers (one block an SM) in {entry.strip()}')
        # Kernels 1, 2, 4, 9 and 10 keep their register tiles (the row ring,
        # the taps' window, the tap sums, the 8 x 8 product tiles) in
        # registers only when every index into them is a constant.
        if any(k in entry for k in ('dwconv_fwd_kernel', 'dwconv_dw_tile_kernel',
                                    'dwconv_dw_sum_kernel', 'weight_grad_kernel',
                                    'input_grad_kernel', 'convnext_block_fwd_',
                                    'convnext_block_bwd_')) \
                and 'stack frame' in line \
                and '0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads' not in line:
            print(f'  NOTE: local memory in {entry.strip()}')
    if not all(f'convnext_block_{k}_kernel' in log
               for k in ('fwd_prep', 'fwd_fc1', 'fwd_fc2', 'bwd_mlp')):
        fail('the build log does not show the fused ConvNeXt block kernels')
    if not all(f'decoder_stage_fwd_{k}_kernel' in log for k in ('conv_a', 'conv_b', 'disp')):
        fail('the build log does not show the decoder-stage kernels')
    if not all(f'photo_bwd_kernelILi{r}ELi{c}E' in log for r in (4, 16) for c in (1, 2, 3, 4)):
        fail('the build log does not show the photometric backward kernel')
    if not all(f'photo_fwd_kernelILi{c}E' in log for c in (1, 2, 3, 4)):
        fail('the build log does not show the photometric forward kernel')
    # Kernels 5 (float) and 6 (unsigned short: bfloat16), C = 1-4 and any C (0).
    if not all(f'warp_bilinear_kernelI{t}Li{c}E' in log for t in 'ft' for c in range(5)):
        fail('the build log does not show every instance of the warp kernel')


def _rand(rs, *shape, scale=1.0):
    return torch.from_numpy((scale * rs.standard_normal(shape)).astype(np.float32)).cuda()


def phase_kernels() -> dict:
    from slowtv_monodepth_tpu_torch.ops import depthwise_conv, depthwise_conv_plain
    rs = np.random.RandomState(0)
    res = {'dwconv': new_result(), 'decoder_stage': new_result()}

    # (b, h, w, c, k, blocks per ConvNeXt-B forward): the four stage shapes
    # at B=2 (timed), at B=1 (a quickstart request), then ragged ones.
    dw_cases = [(2, 96, 160, 128, 7, 3), (2, 48, 80, 256, 7, 3),
                (2, 24, 40, 512, 7, 27), (2, 12, 20, 1024, 7, 3),
                (1, 96, 160, 128, 7, 0), (1, 48, 80, 256, 7, 0),
                (1, 24, 40, 512, 7, 0), (1, 12, 20, 1024, 7, 0),
                (2, 37, 53, 70, 7, 0), (1, 9, 13, 45, 1, 0), (1, 9, 13, 45, 3, 0),
                (1, 9, 13, 45, 5, 0), (1, 9, 13, 45, 9, 0)]
    # The training run's buckets at B=4: ConvNeXt-B's first and last stage,
    # ConvNeXt-T's on the 2 x 4 pose pairs.
    for _, (bh, bw) in run_buckets():
        dw_cases += [(4, bh // 4, bw // 4, 128, 7, 0), (4, bh // 32, bw // 32, 1024, 7, 0),
                     (8, bh // 4, bw // 4, 96, 7, 0), (8, bh // 32, bw // 32, 768, 7, 0)]
    for b, h, w, c, k, n in dw_cases:
        x = _rand(rs, b, h, w, c)
        wt = _rand(rs, c, 1, k, k, scale=1 / k)
        bias = _rand(rs, c, scale=0.1)
        err = (depthwise_conv(x, wt, bias) - depthwise_conv_plain(x, wt, bias)).abs().max().item()
        torch.cuda.synchronize()
        res['dwconv']['err'] = max(res['dwconv']['err'], err)
        line = f'dwconv {(b, h, w, c)} k={k}: max|kernel-plain| {err:.2e} (tol {DWCONV_ATOL:.0e})'
        if n:
            ms = cuda_ms(lambda: depthwise_conv(x, wt, bias))
            pms = cuda_ms(lambda: depthwise_conv_plain(x, wt, bias))
            px = b * h * w * c  # the plain version IS the library call (cuDNN, groups=c)
            line += add_times(res['dwconv'], n, ms, pms,
                              bound_ms(4 * (2 * px + c * k * k + c), 2 * k * k * px), pms)
        print(line)
        if not err <= DWCONV_ATOL:
            # Say which side left the function before failing: both against the
            # plain version in float64, and the same compare evaluated once more.
            ref = depthwise_conv_plain(x.double(), wt.double(), bias.double())
            ek = (depthwise_conv(x, wt, bias) - ref).abs()
            ep = (depthwise_conv_plain(x, wt, bias) - ref).abs()
            fail(f'{line}; evaluated again: kernel vs plain in float64 {ek.max().item():.2e} '
                 f'({int((ek > DWCONV_ATOL).sum())} of {ek.numel()} values off), plain vs plain in '
                 f'float64 {ep.max().item():.2e} ({int((ep > DWCONV_ATOL).sum())} values off)')

    res['decoder_stage_step'], res['decoder_stage_b1'] = new_result(), new_result()
    _stage_kernel_cases(rs, res)
    res['convnext_block'] = _block_kernel_cases(rs)
    torch.cuda.synchronize()
    return res


def _stage_args(rs, b, h, w, ci, cd, misaligned=False) -> tuple:
    """x and the stage's six parameters, fan-in scaled; x one float into its
    storage (not 16-byte aligned) when `misaligned`."""
    x = _rand(rs, b, h, w, ci, scale=0.5)
    if misaligned:
        x = torch.cat([torch.zeros(1, device='cuda'), x.flatten()])[1:].view(x.shape)
    return (x, _rand(rs, cd, ci, 3, 3, scale=1 / np.sqrt(9 * ci)), _rand(rs, cd, scale=0.1),
            _rand(rs, cd, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), _rand(rs, cd, scale=0.1),
            _rand(rs, 1, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), _rand(rs, 1, scale=0.1))


def _stage_kernel_cases(rs, res) -> None:
    """Kernel 3 against the plain stage (ha, feat and disp), two calls bitwise
    equal, at the KBR stages, the training run's buckets and ragged shapes;
    timed per forward at B=2 (res['decoder_stage']), per KBR micro-step (B=4,
    res['decoder_stage_step']) and per request at B=1 (res['decoder_stage_b1']),
    split by CUDA launch at the micro-step's shapes."""
    import torch.nn.functional as F
    from slowtv_monodepth_tpu_torch.ops import decoder_stage as ds
    from slowtv_monodepth_tpu_torch.ops.dwconv import _sm_count
    from slowtv_monodepth_tpu_torch.tools.block_bwd_bench import launch_split
    sms = _sm_count(0)
    timed = {2: res['decoder_stage'], 4: res['decoder_stage_step'], 1: res['decoder_stage_b1']}
    # (b, h, w, ci, cd): KBR stages 1 and 0 at B=2, B=4 and B=1 (timed), then
    # ragged ones: grids of 2 and 3, one decoder channel, channels off 4, input
    # channels over one chunk of 32, decoder channels over one tile, h and w
    # off the tiles; the training run's buckets and the recipe's KITTI bucket at
    # B=4, stages 1 and 0.
    st_cases = [(b, h, w, ci, cd) for b in (2, 4, 1)
                for h, w, ci, cd in ((96, 160, 64, 32), (192, 320, 32, 16))]
    st_cases += [(2, 23, 37, 6, 5), (1, 21, 19, 20, 20), (1, 2, 3, 4, 3), (2, 3, 2, 3, 1),
                 (1, 37, 45, 40, 17)]
    for _, (bh, bw) in run_buckets() + [kitti_bucket()]:
        st_cases += [(4, bh // 4, bw // 4, 64, 32), (4, bh // 2, bw // 2, 32, 16)]
    split, bound9 = {}, {k: 0.0 for k in timed}
    for i, (b, h, w, ci, cd) in enumerate(st_cases + [(1, 10, 12, 32, 16)]):
        misaligned = i == len(st_cases)
        args = _stage_args(rs, b, h, w, ci, cd, misaligned)
        outs = ds._launch_fwd(*args)
        again = ds._launch_fwd(*args)
        want = (ds.stage_ha_plain(*args[:3]), *ds.fused_upconv_stage_plain(*args))
        (fk, dk), errs = ds.fused_upconv_stage(*args), [_max_err(o, t) for o, t in zip(outs, want)]
        torch.cuda.synchronize()
        err = max(errs + [_max_err(fk, want[1]), _max_err(dk, want[2])])
        res['decoder_stage']['err'] = max(res['decoder_stage']['err'], err)
        line = (f'decoder_stage {(b, h, w, ci)} -> cd={cd}{", x not 16-byte aligned" * misaligned}'
                f' plan {ds.fwd_plan(b, h, w, ci, cd, sms)}: max|kernel-plain| ha {errs[0]:.2e}, '
                f'feat {errs[1]:.2e}, disp {errs[2]:.2e} (tol {STAGE_ATOL:.0e}; two calls equal)')
        if not all(torch.equal(u, v) for u, v in zip(outs, again)):
            fail(f'{line}: two calls on the same inputs differ')
        if i < 6:
            ms = cuda_ms(lambda: ds.fused_upconv_stage(*args))
            pms = cuda_ms(lambda: ds.fused_upconv_stage_plain(*args))
            # Library: cuDNN for the stage's three convs alone (zero padding
            # in the call, no ELU, upsample or sigmoid).
            xa = args[0].permute(0, 3, 1, 2)
            ub = torch.empty(b, cd, 2 * h, 2 * w, device='cuda').contiguous(
                memory_format=torch.channels_last)
            lms = cuda_ms(lambda: (F.conv2d(xa, args[1], args[2], padding=1),
                                   F.conv2d(ub, args[3], args[4], padding=1),
                                   F.conv2d(ub, args[5], args[6], padding=1)))
            b9 = bound_ms(*stage_cost(b, h, w, ci, cd, False, taps9=True))
            bound9[b] += max(b9)
            line += add_times(timed[b], 1, ms, pms, bound_ms(*stage_cost(b, h, w, ci, cd, False)),
                              lms) + f' (9-tap bound {max(b9):.4f})'
            if b == 4:
                for k, v in launch_split(lambda: ds._launch_fwd(*args)).items():
                    k = k.replace('decoder_stage_fwd_', '').replace('_kernel', '')
                    split[k] = split.get(k, 0.0) + v
        print(line)
        if not err <= STAGE_ATOL:
            fail(line)
    for b, what in ((1, 'per request at B=1'), (2, 'per forward at B=2'),
                    (4, f'per KBR micro-step (B={TRAIN_B}, 384x640)')):
        r = timed[b]
        print(f'decoder_stage, 2 stages {what}: kernel {r["ms"]:.4f} ms, plain {r["plain_ms"]:.4f}, '
              f'cuDNN three convs {r["library_ms"]:.4f}, bound {r["bound_ms"]:.4f} (9-tap '
              f'{bound9[b]:.4f})' + ('; by CUDA launch (torch.profiler): ' + ', '.join(
                  f'{k} {v:.4f}' for k, v in split.items()) + ' ms' if b == 4 else ''))


def block_cost(b, h, w, c) -> tuple[float, float]:
    """(bytes, float32 operations) of one ConvNeXt block: x in and y out, the
    parameters once; the two matrix products (16 C^2 per pixel) and the 49 taps."""
    p = b * h * w
    return 4 * (2 * p * c + 8 * c * c + 49 * c + 9 * c), 16 * p * c * c + 98 * p * c


def block_bwd_cost(b, h, w, c, kernel10_only: bool = False) -> tuple[float, float]:
    """(bytes, float32 operations) of the fused block's backward,
    `fused_convnext_block_bwd`: the forward's fc1 product again and four more of
    its size (two input gradients, two weight gradients: 40 C^2 per pixel; the
    forward's fc2 product is not needed, dgamma = sum_j fc2 (dy^T hg) + b2 sum dy
    comes from dW2's), the taps forward and their two transposes (kernels 1 and
    2); x and dy in, dx out, the parameters in and their gradients out. With
    `kernel10_only`, kernel 10's share: one pass of taps, du out in place of
    dx, the taps' gradient not written."""
    p = b * h * w
    params = 8 * c * c + 49 * c + 9 * c
    if kernel10_only:
        return 4 * (3 * p * c + 2 * params - 49 * c), 40 * p * c * c + 98 * p * c
    return 4 * (3 * p * c + 2 * params), 40 * p * c * c + 3 * 98 * p * c


def _block_args(rs, b, h, w, c) -> tuple:
    """x and the block's nine parameters, fan-in scaled (O(1) activations)."""
    return (_rand(rs, b, h, w, c), _rand(rs, c, 1, 7, 7, scale=1 / 7), _rand(rs, c, scale=0.1),
            1 + _rand(rs, c, scale=0.1), _rand(rs, c, scale=0.1),
            _rand(rs, 4 * c, c, scale=c ** -0.5), _rand(rs, 4 * c, scale=0.1),
            _rand(rs, c, 4 * c, scale=(4 * c) ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, c, scale=0.5))


def _unfused_block(x, dww, dwb, lnw, lnb, w1, b1, w2, b2, gamma):
    """The block as the net runs it with the blocks unfused: kernel 1, then
    PyTorch's LayerNorm and cuBLAS."""
    import torch.nn.functional as F
    from slowtv_monodepth_tpu_torch.ops import depthwise_conv
    u = F.layer_norm(depthwise_conv(x, dww, dwb), (x.shape[-1],), lnw, lnb, 1e-6)
    return x + gamma * F.linear(F.gelu(F.linear(u, w1, b1)), w2, b2)


def _block_kernel_cases(rs) -> dict:
    """Kernel 9 against the unfused block in float64, two calls bitwise equal;
    times at the ConvNeXt-B shapes of a request and at the KBR micro-step's
    block shapes."""
    from slowtv_monodepth_tpu_torch.ops import fused_convnext_block, fused_convnext_block_plain
    from slowtv_monodepth_tpu_torch.ops import convnext_block as cb
    from slowtv_monodepth_tpu_torch.ops.dwconv import _sm_count
    from slowtv_monodepth_tpu_torch.tools.block_bwd_bench import launch_split
    res = new_result()
    sms, slots = _sm_count(0), cb._cluster_blocks(0)
    print(f'convnext_block: {sms} SMs; product blocks at once in clusters of '
          f'{cb._FWD_SPLITS}: {slots}')

    def fwd_plan(b, h, w, c):
        return cb.fwd_plan(b, h, w, c, sms, slots)
    stages = list(zip((96, 48, 24, 12), (160, 80, 40, 20), (128, 256, 512, 1024),
                      CONVNEXT_B_BLOCKS))
    # (b, h, w, c): the four stage shapes at B=2 and at B=1 (where the blocks of
    # a cluster split the products' K), ragged shapes (pixel counts off the
    # 128-pixel tile and off 4, heights under the 7x7 halo, channels off 128),
    # then what a request at two of the run's bucket shapes gives the first and
    # last stage.
    cases = [(b, h, w, c) for b in (2, 1) for h, w, c, _ in stages]
    cases += [(2, 37, 53, 160), (1, 5, 7, 96), (1, 3, 4, 40), (3, 9, 9, 264), (1, 7, 11, 1536)]
    cases += [shape[:4] for shape in STEP_BLOCKS[4:]]  # the pose net's ConvNeXt-T, training only
    for _, (bh, bw) in run_buckets():
        cases += [(1, bh // 4, bw // 4, 128), (1, bh // 32, bw // 32, 1024)]

    for shape in cases:
        args = _block_args(rs, *shape)
        for approximate in (False, True):
            want = fused_convnext_block_plain(*(t.double() for t in args), approximate=approximate)
            got = fused_convnext_block(*args, approximate=approximate)
            again = fused_convnext_block(*args, approximate=approximate)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f'convnext_block {shape}: two calls on the same inputs differ')
            scale = float(want.abs().max())
            err = _max_err(got, want) / scale
            p32 = _max_err(fused_convnext_block_plain(*args, approximate=approximate), want) / scale
            res['err'] = max(res['err'], err)
            line = (f'convnext_block {shape} {"tanh" if approximate else "erf"} plan '
                    f'{fwd_plan(*shape)}: max|kernel-plain(f64)| / max|y| {err:.2e} (tol '
                    f'{BLOCK_RTOL:.0e}; plain f32 {p32:.2e}; max|y| {scale:.2f}; two calls equal)')
            print(line)
            if not err <= BLOCK_RTOL:
                fail(line)

    # Times: a request is B=1 (what the kernels line carries), a batch B=4;
    # then the KBR micro-step's 54 blocks (the kernels line's step_*), with
    # kernel 9's device time split by CUDA launch.
    res['step'] = new_result()
    for name, shapes, total in (
            ('36 blocks at B=1', [(1, h, w, c, n) for h, w, c, n in stages], res),
            ('36 blocks at B=4', [(4, h, w, c, n) for h, w, c, n in stages], new_result()),
            (f'54 blocks per KBR micro-step (B={TRAIN_B}, 384x640)', STEP_BLOCKS, res['step'])):
        unfused, split = 0.0, {}
        for b, h, w, c, n in shapes:
            args = _block_args(rs, b, h, w, c)
            ms = cuda_ms(lambda: fused_convnext_block(*args), iters=10)
            pms = cuda_ms(lambda: fused_convnext_block_plain(*args), iters=10)
            ums = cuda_ms(lambda: _unfused_block(*args), iters=10)
            cost = block_cost(b, h, w, c)
            times = add_times(total, n, ms, pms, bound_ms(*cost))
            print(f'convnext_block {(b, h, w, c)}: plan {fwd_plan(b, h, w, c)}, '
                  f'{cost[1] / ms.ms / 1e9:.1f} TFLOP/s; unfused with kernel 1 {ums.ms:.4f} '
                  f'({ums.eager_ms:.4f}) ms{times}')
            unfused += n * ums.ms
            if total is res['step']:
                for k, v in launch_split(lambda: fused_convnext_block(*args)).items():
                    k = k.replace('convnext_block_fwd_', '').replace('_kernel', '')
                    split[k] = split.get(k, 0.0) + n * v
            del args
        print(f'convnext_block, {name}: kernel {total["ms"]:.3f} ms, plain {total["plain_ms"]:.3f} '
              f'ms, unfused with kernel 1 {unfused:.3f} ms, bound {total["bound_ms"]:.3f} ms'
              + ('; by CUDA launch (torch.profiler): '
                 + ', '.join(f'{k} {v:.3f}' for k, v in split.items()) + ' ms' if split else ''))
    return res


def _seeded_net(seed: int, kernels: bool, sd=None, fused_blocks: bool = False):
    from slowtv_monodepth_tpu_torch.models import DepthNet, seeded_state_dict
    if sd is None:
        with torch.device('meta'):
            meta = DepthNet(**KBR_DEPTH_CFG)
        sd = {k: torch.from_numpy(v) for k, v in seeded_state_dict(meta, seed).items()}
    net = DepthNet(**KBR_DEPTH_CFG, kernels=kernels, fused_blocks=fused_blocks)
    net.load_state_dict(sd)
    return net.cuda().eval(), sd


def phase_golden():
    with np.load(GOLDEN) as f:
        gold = {k: f[k] for k in f.files}
    net, sd = _seeded_net(int(gold['seed']), kernels=True)
    x = torch.from_numpy(gold['x']).cuda().permute(0, 3, 1, 2)
    for tag, net in (('', net), (', fused blocks', _seeded_net(0, True, sd, fused_blocks=True)[0])):
        with torch.no_grad():
            disp = net(x)['disp']
        for s in range(4):
            got = disp[s].permute(0, 2, 3, 1).cpu().numpy()
            want = gold[f'disp_{s}']
            if got.shape != want.shape:
                fail(f'golden disp {s}{tag}: shape {got.shape} vs {want.shape}')
            err = float(np.abs(got - want).max())
            print(f'golden ConvNeXt-B{tag} disp[{s}] {got.shape}: max|port-JAX| {err:.2e} '
                  f'(tol {GOLDEN_ATOL:.0e})')
            if not err <= GOLDEN_ATOL:
                fail(f'golden disp {s}{tag} off by {err}')
    return sd


def _make_scenes() -> list[np.ndarray]:
    spec = importlib.util.spec_from_file_location('demo_generate', ROOT / 'assets' / 'generate.py')
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return [gen.make_scene(kind, seed=s).astype(np.float32) / 255.0
            for kind in gen.PALETTES for s in (1, 2)]


def _time_requests(net, imgs: np.ndarray, n: int = 5) -> list[float]:
    from slowtv_monodepth_tpu_torch.quickstart import predict
    predict(net, imgs)  # warm
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        predict(net, imgs)  # ends in a device -> host copy
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_slice(sd, scenes) -> dict:
    from slowtv_monodepth_tpu_torch.core import BenchmarkPredictor, save_checkpoint
    from slowtv_monodepth_tpu_torch.ops import (depthwise_conv, fused_convnext_block,
                                                fused_upconv_stage)
    from slowtv_monodepth_tpu_torch.quickstart import predict, save_disp

    def serve(tmp: Path, name: str, depth_cfg: dict):
        """checkpoint -> predictor -> one request per scene -> (net, launches, maps)."""
        cfg = {'net': {'depth': depth_cfg}, 'trainer': KBR_TRAINER_CFG}
        save_checkpoint(tmp / f'{name}.ckpt', {'depth': sd}, cfg)
        net = BenchmarkPredictor('cuda').load_model(tmp / f'{name}.ckpt')
        counted = {'dwconv': depthwise_conv, 'decoder_stage': fused_upconv_stage,
                   'convnext_block': fused_convnext_block}
        for f in counted.values():
            f.launches = 0
        for i, img in enumerate(scenes):
            save_disp(predict(net, img), f'{name}_{i}', tmp, ['.npy'])
        torch.cuda.synchronize()
        return (net, {k: f.launches for k, f in counted.items()},
                [np.load(tmp / f'{name}_{i}.npy') for i in range(len(scenes))])

    with tempfile.TemporaryDirectory() as tmp:
        net, launches, outs = serve(Path(tmp), 'request', KBR_DEPTH_CFG)
        fused, fused_launches, fused_outs = serve(Path(tmp), 'fused_request',
                                                  {**KBR_DEPTH_CFG, 'fused_blocks': True})

    print(f'slice: {len(scenes)} requests, launches {launches}')
    for i, d in enumerate(outs):
        ok = (d.shape == scenes[i].shape[:2] and np.isfinite(d).all()
              and 0 < d.min() and d.max() < 1 and d.std() > 1e-4)
        print(f'  request {i}: disp {d.shape} range [{d.min():.4f}, {d.max():.4f}] '
              f'std {d.std():.4f} {"ok" if ok else "BAD"}')
        if not ok:
            fail(f'request {i} output is not a finite, non-constant (0, 1) map')
    n_blocks = sum(CONVNEXT_B_BLOCKS) * len(scenes)
    want = {'dwconv': n_blocks, 'decoder_stage': 2 * len(scenes), 'convnext_block': 0}
    if launches != want:
        fail(f'launch counts {launches}, expected {want}')

    # The same requests through the checkpoint whose cfg turns the fused blocks on.
    want = {'dwconv': 0, 'decoder_stage': 2 * len(scenes), 'convnext_block': n_blocks}
    if fused_launches != want:
        fail(f'fused blocks: launch counts {fused_launches}, expected {want}')
    err = max(float(np.abs(a - b).max()) for a, b in zip(fused_outs, outs))
    print(f'slice, fused blocks: {len(scenes)} requests, launches {fused_launches}; '
          f'max|fused - unfused| over the maps {err:.2e} (tol {GOLDEN_ATOL:.0e})')
    if not err <= GOLDEN_ATOL:
        fail(f'the fused blocks serve another map: off by {err}')
    x = torch.zeros(1, 3, 64, 96, device='cuda')
    disp = fused(x)['disp'][0]  # under grad: the autograd Function, never a cut graph
    if disp.grad_fn is None or fused_convnext_block.launches != n_blocks + sum(CONVNEXT_B_BLOCKS):
        fail('a forward of the fused blocks under grad lost its grad_fn or its launches')
    print('slice, fused blocks: a forward under grad keeps its grad_fn')

    plain, _ = _seeded_net(0, kernels=False, sd=sd)
    nets = {'kernel': net, 'fused': fused, 'plain': plain}
    for b in (1, 4):
        imgs = np.stack([scenes[i % len(scenes)] for i in range(b)])
        samples = {name: [] for name in nets}
        for name in ('plain', 'kernel', 'fused', 'fused', 'kernel', 'plain'):
            samples[name] += _time_requests(nets[name], imgs)
        for name, ts in samples.items():
            med = float(np.median(ts))
            print(f'serving B={b} {name:6s}: median {med:.2f} ms/request '
                  f'(min {min(ts):.2f}, max {max(ts):.2f}, n={len(ts)}), '
                  f'{1e3 * b / med:.1f} images/s')
    return {**launches, 'convnext_block': fused_launches['convnext_block']}


# ------------------------------------------------------------- training path
def _counters() -> dict:
    """Kernel name -> its wrapper, which carries the `launches` count."""
    from slowtv_monodepth_tpu_torch.ops import convnext_block, decoder_stage, dwconv, photo, sample
    return {'convnext_block': convnext_block.fused_convnext_block,
            'convnext_block_bwd': convnext_block.fused_convnext_block_bwd,
            'dwconv': dwconv.depthwise_conv, 'decoder_stage': decoder_stage.fused_upconv_stage,
            'decoder_stage_bwd': decoder_stage.fused_upconv_stage_bwd,
            'dwconv_dw': dwconv.dwconv_dw, 'warp': sample.warp_bilinear,
            'warp_packed': sample.warp_bilinear_packed,
            'photo_fwd': photo.photo_fwd, 'photo_bwd': photo.photo_bwd}


def _reset_counts() -> None:
    for f in _counters().values():
        f.launches = 0


def _read_counts() -> dict:
    return {k: f.launches for k, f in _counters().items()}


def _max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max().item())


def _scene_pair(scenes, m: int, rs):
    """(m, 384, 640, 3) targets from the scenes and sources a few px off, as
    a warped support is: smooth skies and textured ground, real ties at 0."""
    y = torch.from_numpy(np.stack([scenes[i % len(scenes)] for i in range(m)])).cuda()
    x = torch.roll(y, shifts=(int(rs.randint(1, 3)), int(rs.randint(1, 4))), dims=(1, 2))
    x = (x + 0.01 * torch.from_numpy(rs.standard_normal(x.shape).astype(np.float32)).cuda())
    return x.clamp(0, 1).contiguous(), y.contiguous()


def phase_train_kernels(scenes) -> dict:
    import torch.nn.functional as F
    from slowtv_monodepth_tpu_torch.core.aspect_ratio import crop_grid
    from slowtv_monodepth_tpu_torch.ops import decoder_stage, dwconv, photo, sample
    rs = np.random.RandomState(1)
    res = {k: new_result() for k in ('dwconv_dw', 'dwconv_step', 'decoder_stage_bwd', 'warp',
                                     'warp_packed', 'photo_fwd', 'photo_bwd')}
    res['convnext_block_bwd'] = _block_bwd_cases(rs)

    def record(name, err, tol, line, n=0, fn=None, plain=None, bound=None, library=None):
        res[name]['err'] = max(res[name]['err'], err)
        line += f': max|kernel-plain(f64)| {err:.2e} (tol {tol:.1e})'
        if n:
            ms, pms = cuda_ms(fn, iters=10), cuda_ms(plain, iters=10)
            lms = None if library is None else (
                pms if library == 'plain' else cuda_ms(library, iters=10))
            line += add_times(res[name], n, ms, pms, bound_ms(*bound), lms)
        print(line)
        if not err <= tol:
            fail(line)

    # Tap gradient at the step's block shapes: ConvNeXt-B at B=4, ConvNeXt-T
    # on the 2 x 4 pose pairs, then ragged ones; taps normalized to O(1).
    dw_cases = [(4, 96, 160, 128, 7, 3), (4, 48, 80, 256, 7, 3), (4, 24, 40, 512, 7, 27),
                (4, 12, 20, 1024, 7, 3), (8, 96, 160, 96, 7, 3), (8, 48, 80, 192, 7, 3),
                (8, 24, 40, 384, 7, 9), (8, 12, 20, 768, 7, 3),
                (2, 37, 53, 70, 7, 0), (1, 9, 13, 45, 3, 0), (1, 9, 13, 45, 9, 0)]
    for _, (bh, bw) in run_buckets():  # the run's buckets: first and last stage of both nets
        dw_cases += [(4, bh // 4, bw // 4, 128, 7, 0), (4, bh // 32, bw // 32, 1024, 7, 0),
                     (8, bh // 4, bw // 4, 96, 7, 0), (8, bh // 32, bw // 32, 768, 7, 0)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, h, w, c, k, n in dw_cases:
        x = _rand(rs, b, h, w, c)
        g = _rand(rs, b, h, w, c, scale=1 / np.sqrt(b * h * w))
        got = dwconv.dwconv_dw(x, g, k)
        err = _max_err(got, dwconv.dwconv_dw_plain(x.double(), g.double(), k))
        if n and not torch.equal(dwconv.dwconv_dw(x, g, k), got):
            fail(f'dwconv_dw {(b, h, w, c)} k={k}: two calls differ (the sums must run in a fixed order)')
        px = b * h * w * c  # the plain version IS the library call (cuDNN's weight gradient)
        record('dwconv_dw', err, DW_ATOL, f'dwconv_dw {(b, h, w, c)} k={k}, plan '
               f'{dwconv.dw_plan(b, h, w, c, k, sms)}' + (', two calls bitwise equal' if n else ''), n,
               lambda: dwconv.dwconv_dw(x, g, k), lambda: dwconv.dwconv_dw_plain(x, g, k),
               (4 * (2 * px + k * k * c), 2 * k * k * px), 'plain')

    # Kernel 1 at the same eight block shapes, timed per micro-step: each block
    # launches it twice, forward and input gradient (the same kernel on the
    # cotangent, taps flipped, no bias), so each shape counts x2. Its own seed,
    # so that the later cases draw what they drew before.
    rs1 = np.random.RandomState(7)
    for b, h, w, c, n in STEP_BLOCKS:
        x, wt, bias = _rand(rs1, b, h, w, c), _rand(rs1, c, 1, 7, 7, scale=1 / 7), _rand(rs1, c, scale=0.1)
        err = _max_err(dwconv.depthwise_conv(x, wt, bias),
                       dwconv.depthwise_conv_plain(x.double(), wt.double(), bias.double()))
        px = b * h * w * c  # the plain version IS the library call (cuDNN, groups=c)
        record('dwconv_step', err, DWCONV_ATOL, f'dwconv {(b, h, w, c)} k=7, training step', 2 * n,
               lambda: dwconv.depthwise_conv(x, wt, bias),
               lambda: dwconv.depthwise_conv_plain(x, wt, bias),
               (4 * (2 * px + 49 * c + c), 2 * 49 * px), 'plain')
    for name, what in (('dwconv_step', 'dwconv, 108'), ('dwconv_dw', 'dwconv_dw, 54')):
        r = res[name]
        print(f'{what} launches per KBR micro-step (B={TRAIN_B}, 384x640): device ms (eager) '
              f'kernel {r["ms"]:.3f} ({r["eager_ms"]:.3f}), cuDNN {r["plain_ms"]:.3f} '
              f'({r["plain_eager_ms"]:.3f}), bound {r["bound_ms"]:.3f}')

    # The decoder stage's backward (kernel 4) through the autograd Function:
    # KBR stages 1 and 0 at B=4 (timed), ragged shapes, grids of 2 and 3
    # where a reflect fold lands on the row it left, both stages at the run's
    # augmentation buckets; with both cotangents, g_feat alone and g_disp alone.
    names = ('dx', 'dwa', 'dba', 'dwb', 'dbb', 'dwo', 'dbo')
    st_cases = [(4, 96, 160, 64, 32, 1), (4, 192, 320, 32, 16, 1), (2, 23, 37, 6, 5, 0),
                (1, 21, 19, 20, 20, 0), (1, 2, 3, 4, 3, 0), (2, 3, 2, 2, 2, 0),
                (4, 56, 176, 32, 16, 0)]
    for _, (bh, bw) in run_buckets() + [kitti_bucket()]:  # with the recipe's KITTI bucket
        st_cases += [(4, bh // 4, bw // 4, 64, 32, 0), (4, bh // 2, bw // 2, 32, 16, 0)]
    for b, h, w, ci, cd, n in st_cases:
        args = (_rand(rs, b, h, w, ci, scale=0.5),
                _rand(rs, cd, ci, 3, 3, scale=1 / np.sqrt(9 * ci)), _rand(rs, cd, scale=0.1),
                _rand(rs, cd, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), _rand(rs, cd, scale=0.1),
                _rand(rs, 1, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), _rand(rs, 1, scale=0.1))
        g_feat, g_disp = _rand(rs, b, 2 * h, 2 * w, cd), _rand(rs, b, 2 * h, 2 * w, 1)
        leaves = [t.clone().requires_grad_() for t in args]
        feat, disp = decoder_stage.fused_upconv_stage(*leaves)
        if feat.grad_fn is None or disp.grad_fn is None:
            fail('fused_upconv_stage under grad is cut off from autograd')
        saved = feat.grad_fn.saved_tensors  # x, six parameters, ha, feat, disp
        once = decoder_stage.fused_upconv_stage_bwd(*saved, g_feat, g_disp)
        again = decoder_stage.fused_upconv_stage_bwd(*saved, g_feat, g_disp)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(once, again)):
            fail(f'decoder_stage_bwd {(b, h, w, ci)} -> cd={cd}: two calls on the same inputs differ')
        for mode, gf, gd in (('both', g_feat, g_disp), ('g_feat', g_feat, None),
                             ('g_disp', None, g_disp)):
            pairs = [(o, g) for o, g in ((feat, gf), (disp, gd)) if g is not None]
            got = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs],
                                      retain_graph=True)
            want = decoder_stage.fused_upconv_stage_bwd_plain(
                *(t.double() for t in args), *(None if g is None else g.double() for g in (gf, gd)))
            wsum = max(1.0, np.sqrt(4 * b * h * w) / 16)
            errs = {k: _max_err(a, t) / (float(t.abs().max()) or 1.0)
                    for k, a, t in zip(names, got, want)}
            worst = max(errs['dx'], max(v for k, v in errs.items() if k != 'dx') / wsum)
            timed = n and mode == 'both'
            plain_leaves = [t.clone().requires_grad_() for t in args]
            with on_timing_stream():  # the library call below times this forward's backward
                plain_outs = decoder_stage.fused_upconv_stage_plain(*plain_leaves) if timed else None
            record('decoder_stage_bwd', worst, STAGE_BWD_RTOL,
                   f'decoder_stage_bwd {(b, h, w, ci)} -> cd={cd}, {mode} (each relative to its own '
                   f'max|grad|; dx {errs["dx"]:.1e}, weight sums '
                   f'{max(errs[k] for k in names[1:]):.1e} over {wsum:.0f})', n if timed else 0,
                   lambda: decoder_stage.fused_upconv_stage_bwd(*saved, g_feat, g_disp),
                   lambda: decoder_stage.fused_upconv_stage_bwd_plain(*args, g_feat, g_disp),
                   stage_cost(b, h, w, ci, cd, True),
                   # library: cuDNN's backward of the plain stage, its forward already done
                   lambda: torch.autograd.grad(plain_outs, plain_leaves, [g_feat, g_disp],
                                               retain_graph=True))

    # Warp: the step's (2 supports x 4 scales x B=4) stack of 384x640 RGB at
    # near-identity video coords, then ragged shapes at random coords.
    m = 2 * 4 * TRAIN_B
    img, _ = _scene_pair(scenes, m, rs)
    ys, xs = torch.meshgrid(torch.arange(384.), torch.arange(640.), indexing='ij')
    fx = (xs.cuda() + 2 + torch.randn(m, 384, 640, device='cuda')).clamp(0, 639).contiguous()
    fy = (ys.cuda() + 0.5 * torch.randn(m, 384, 640, device='cuda')).clamp(0, 383).contiguous()
    cases = [(img, fx, fy, 1)]
    for b, h, w, c, ho, wo in [(3, 37, 53, 3, 29, 41), (1, 5, 7, 8, 9, 4)]:
        cases.append((_rand(rs, b, h, w, c),
                      torch.from_numpy(rs.uniform(0, w - 1, (b, ho, wo)).astype(np.float32)).cuda(),
                      torch.from_numpy(rs.uniform(0, h - 1, (b, ho, wo)).astype(np.float32)).cuda(),
                      0))
    for b, h, w, c, ho, wo in [(1, 16, 20, 1, 9, 7), (2, 9, 11, 2, 6, 7)]:  # for kernel 6
        cases.append((_rand(rs, b, h, w, c),
                      torch.from_numpy(rs.uniform(0, w - 1, (b, ho, wo)).astype(np.float32)).cuda(),
                      torch.from_numpy(rs.uniform(0, h - 1, (b, ho, wo)).astype(np.float32)).cuda(),
                      0))
    # The training run's shapes: the augmentation's resample of the B=4 targets and
    # the 2 x 4 supports from 720x1280 onto a bucket, at the coords `crop_resize`
    # gives the warp, and the step's stack at that bucket.
    native = torch.nn.functional.interpolate(
        img[:2 * TRAIN_B].permute(0, 3, 1, 2), size=RUN_SRC_SHAPE, mode='bilinear',
        align_corners=False).permute(0, 2, 3, 1).contiguous()
    for crop, (bh, bw) in run_buckets():
        for src in (native[:TRAIN_B], native):
            cx, cy = sample.border_coords(crop_grid(src, crop, (bh, bw)), *RUN_SRC_SHAPE)
            cases.append((src, cx, cy, 0))
        ys, xs = torch.meshgrid(torch.arange(float(bh)), torch.arange(float(bw)), indexing='ij')
        cases.append((
            torch.rand(m, bh, bw, 3, device='cuda'),
            (xs.cuda() + 2 + torch.randn(m, bh, bw, device='cuda')).clamp(0, bw - 1).contiguous(),
            (ys.cuda() + 0.5 * torch.randn(m, bh, bw, device='cuda')).clamp(0, bh - 1).contiguous(),
            0))
    cases = [(*c, 1.0) for c in cases]  # (source, coords, launches, tolerance / WARP_ATOL)
    # The recipe's KITTI batches: the B=4 targets from 376x1242 onto its bucket, and their
    # sparse benchmark depth (C = 1, values up to 80 m: held to WARP_ATOL times max|depth|).
    crop, bucket = kitti_bucket()
    kitti = torch.nn.functional.interpolate(
        img[:TRAIN_B].permute(0, 3, 1, 2), size=RECIPE_DEPTH_SHAPE, mode='bilinear',
        align_corners=False).permute(0, 2, 3, 1).contiguous()
    depth = torch.from_numpy(sparse_depth(np.random.RandomState(11), TRAIN_B)).cuda()  # own seed
    for src, scale in ((kitti, 1.0), (depth, float(depth.abs().max()))):
        cx, cy = sample.border_coords(crop_grid(src, crop, bucket), *RECIPE_DEPTH_SHAPE)
        cases.append((src, cx, cy, 0, scale))
        # Timed per call, outside the kernels line's per-micro-step sums: one call each
        # per KITTI batch of the recipe (its images' resample is one of its four).
        t = cuda_ms(lambda: sample.warp_bilinear(src, cx, cy), iters=10)
        pt = cuda_ms(lambda: sample.warp_bilinear_plain(src, cx, cy), iters=10)
        bound = bound_ms(4 * (src.numel() + 2 * cx.numel() + 3 * cx.numel() * src.shape[-1]),
                         14 * cx.numel() * src.shape[-1])
        print(f'warp {tuple(src.shape)} -> {bucket}, per call: device ms (eager) kernel '
              f'{t.ms:.4f} ({t.eager_ms:.4f}), plain {pt.ms:.4f} ({pt.eager_ms:.4f}), bound '
              f'{max(bound):.4f} ({"bytes" if bound[0] >= bound[1] else "operations"})')

    def library_warp(im, cx, cy):
        """`F.grid_sample` on the same samples (it returns the sample only, not ddx, ddy)."""
        h, w = im.shape[1:3]
        grid = torch.stack([(2 * cx + 1) / w - 1, (2 * cy + 1) / h - 1], -1)
        return lambda: F.grid_sample(im.float().permute(0, 3, 1, 2), grid, mode='bilinear',
                                     padding_mode='border', align_corners=False)

    for im, cx, cy, n, scale in cases:
        got = sample.warp_bilinear(im, cx, cy)
        want = sample.warp_bilinear_plain(im.double(), cx.double(), cy.double())
        px, pout = im.numel(), got[0].numel()
        lib = library_warp(im, cx, cy)
        lib_err = _max_err(lib().permute(0, 2, 3, 1), want[0])
        of = '' if scale == 1.0 else f' x max|source| {scale:.3g}'
        record('warp', max(_max_err(a, b) for a, b in zip(got, want)), WARP_ATOL * scale,
               f'warp {tuple(im.shape)} -> {tuple(cx.shape[1:])}{of} (F.grid_sample off by '
               f'{lib_err:.1e})', n, lambda: sample.warp_bilinear(im, cx, cy),
               lambda: sample.warp_bilinear_plain(im, cx, cy),
               (4 * (px + 2 * cx.numel() + 3 * pout), 14 * pout), lib)
        # Kernel 6: the same warp on the bfloat16-rounded source, against the
        # plain version on the widened source and against kernel 5 on it.
        im16 = im.to(torch.bfloat16)
        got16 = sample.warp_bilinear(im16, cx, cy)
        want16 = sample.warp_bilinear_plain(im16.double(), cx.double(), cy.double())
        k5 = sample.warp_bilinear(im16.float(), cx, cy)
        vs_k5 = max(_max_err(a, b) for a, b in zip(got16, k5))
        if any(t.dtype != torch.float32 for t in got16) or not vs_k5 <= 1e-6:
            fail(f'warp_packed {tuple(im.shape)}: off kernel 5 on the widened source by {vs_k5:.2e}')
        record('warp_packed', max(_max_err(a, b) for a, b in zip(got16, want16)), WARP_ATOL * scale,
               f'warp_packed {tuple(im.shape)} bf16 -> {tuple(cx.shape[1:])}{of} (vs kernel 5 on the '
               f'widened source {vs_k5:.1e})', n, lambda: sample.warp_bilinear(im16, cx, cy),
               lambda: sample.warp_bilinear_plain(im16, cx, cy),
               (2 * px + 4 * (2 * cx.numel() + 3 * pout), 14 * pout),
               library_warp(im16, cx, cy))  # the library call on the source widened in the call

    from slowtv_monodepth_tpu_torch.tools.warp_bench import digests as warp_digests
    digests = warp_digests()
    if digests != WARP_SHA256:
        fail(f'warp: out, ddx, ddy are not the parent checkout\'s: {digests}')
    print('warp, warp_packed: out, ddx and ddy have the parent checkout\'s sha256 at the '
          'step\'s stack and a resample')

    # Photometric error: the warped stack (m=32) and the static stack (m=8)
    # forward, the warped stack backward; then ragged shapes with exact ties.
    for mm, n_fwd, n_bwd in [(m, 1, 1), (2 * TRAIN_B, 1, 0)]:
        x, y = _scene_pair(scenes, mm, rs)
        g = torch.from_numpy(rs.rand(mm, 384, 640).astype(np.float32)).cuda()
        _photo_case(record, x, y, g, n_fwd, n_bwd)
    # the warped and the static stack at the run's buckets and the recipe's KITTI bucket
    for _, (bh, bw) in run_buckets() + [kitti_bucket()]:
        for mm in (m, 2 * TRAIN_B):
            x, y = (F.interpolate(t.permute(0, 3, 1, 2), size=(bh, bw), mode='bilinear',
                                  align_corners=False).permute(0, 2, 3, 1).contiguous()
                    for t in _scene_pair(scenes, mm, rs))
            g = torch.from_numpy(rs.rand(mm, bh, bw).astype(np.float32)).cuda()
            _photo_case(record, x, y, g, 0, 0)
    # Ragged shapes with exact ties, also at kernel 8's tile edges (62 columns,
    # 4-16 rows): h = 2, w = 2, C = 1 and 2, two and three tiles wide; and at
    # kernel 7's (128 columns, 6 rows): one past a tile, on two, C = 4.
    for shape in [(2, 37, 70, 3), (1, 2, 2, 3), (3, 19, 33, 1), (2, 2, 67, 3), (1, 35, 2, 2),
                  (1, 17, 125, 1), (2, 33, 124, 3), (2, 9, 129, 3), (1, 16, 256, 4),
                  (1, 25, 385, 2)]:
        x = torch.from_numpy(rs.rand(*shape).astype(np.float32)).cuda()
        y = torch.from_numpy(rs.rand(*shape).astype(np.float32)).cuda()
        y[:, :, : shape[2] // 2] = x[:, :, : shape[2] // 2]  # x == y: S == 0 exactly
        _photo_case(record, x, y, torch.from_numpy(rs.rand(*shape[:3]).astype(np.float32)).cuda(),
                    0, 0)
    from slowtv_monodepth_tpu_torch.tools.photo_bench import bwd_digests, fwd_digests
    digests = fwd_digests()
    if digests != PHOTO_FWD_SHA256:
        fail(f'photo_fwd: the error map is not the parent checkout\'s: {digests}')
    print(f'photo_fwd: the map has the parent checkout\'s sha256 at {sorted(digests)}')
    digests = bwd_digests()
    if digests != PHOTO_BWD_SHA256:
        fail(f'photo_bwd: dx and dy are not the parent checkout\'s: {digests}')
    print('photo_bwd: dx and dy have the parent checkout\'s sha256 at (32, 384, 640, 3)')
    torch.cuda.synchronize()
    return res


BLOCK_GRADS = ('dx', 'd dw_weight', 'd dw_bias', 'd ln_weight', 'd ln_bias', 'd fc1_weight',
               'd fc1_bias', 'd fc2_weight', 'd fc2_bias', 'd gamma')


def _block_bwd_cases(rs) -> dict:
    """Kernel 10 (+ kernels 1 and 2) against the plain backward in float64 at
    the step's block shapes and ragged ones; times per KBR micro-step."""
    from slowtv_monodepth_tpu_torch.ops import convnext_block as cb
    from slowtv_monodepth_tpu_torch.tools.block_bwd_bench import launch_split
    res = new_result()
    res.update(unfused_ms=0.0, k10_ms=0.0, k10_bound_ms=0.0)
    split: dict[str, float] = {}  # kernel 10's CUDA launches, device ms per micro-step
    # (b, h, w, c, blocks per micro-step, tanh, floor): the step's eight shapes
    # (erf, the KBR recipe's GELU; tanh at one of them), then ragged ones: pixel
    # counts off every tile, heights under the 7x7 halo, channels off 32 and over
    # 256. The 4-ulp floor is for the ragged shapes of a few dozen pixels only.
    cases = [(*shape, False, 0.0) for shape in STEP_BLOCKS] + [(4, 24, 40, 512, 0, True, 0.0)]
    cases += [(*shape, BLOCK_BWD_FLOOR) for shape in (
        (2, 37, 53, 160, 0, False), (2, 37, 53, 160, 0, True), (1, 5, 7, 96, 0, False),
        (1, 3, 4, 40, 0, True), (3, 9, 9, 264, 0, False), (1, 1, 1, 8, 0, False))]
    for b, h, w, c, n, approximate, floor in cases:
        args = _block_args(rs, b, h, w, c)
        dy = _rand(rs, b, h, w, c)
        got = cb.fused_convnext_block_bwd(args[0], dy, *args[1:], approximate=approximate)
        again = cb.fused_convnext_block_bwd(args[0], dy, *args[1:], approximate=approximate)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            fail(f'convnext_block_bwd {(b, h, w, c)}: two calls on the same inputs differ')
        want = cb.fused_convnext_block_bwd_plain(*(t.double() for t in (args[0], dy, *args[1:])),
                                                 approximate=approximate)
        p32 = cb.fused_convnext_block_bwd_plain(args[0], dy, *args[1:], approximate=approximate)
        scale = [float(t.abs().max()) for t in want]
        err = [_max_err(u, t) / sc for u, t, sc in zip(got, want, scale)]
        perr = [_max_err(u, t) / sc for u, t, sc in zip(p32, want, scale)]
        res['err'] = max(res['err'], max(err))
        line = (f'convnext_block_bwd {(b, h, w, c)} {"tanh" if approximate else "erf"}: ten '
                f'gradients, max|kernel-plain(f64)| / max|grad| (tol 2x plain f32'
                f'{" + 4 ulps" if floor else ""}; bitwise repeatable): ' + ', '.join(f'{k} {e:.1e} ({p:.1e})' for k, e, p in
                                            zip(BLOCK_GRADS, err, perr)))
        if n:
            # ms, plain_ms and the bound over one span, the whole block backward
            # (kernel 10, then kernels 1 and 2); kernel 10 alone beside it.
            ms = cuda_ms(lambda: cb.fused_convnext_block_bwd(args[0], dy, *args[1:]), iters=10)
            pms = cuda_ms(lambda: cb.fused_convnext_block_bwd_plain(args[0], dy, *args[1:]),
                          iters=10)
            k10 = cuda_ms(lambda: cb.block_bwd_kernel(args[0], dy, *args[1:]), iters=10)
            k10_bound = max(bound_ms(*block_bwd_cost(b, h, w, c, kernel10_only=True)))
            leaves = [t.clone().requires_grad_() for t in args]
            with on_timing_stream():  # its backward is what is timed
                y = _unfused_block(*leaves)
            ums = cuda_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True), iters=10)
            res['unfused_ms'] += n * ums.ms
            res['k10_ms'] += n * k10.ms
            by_launch = launch_split(lambda: cb.block_bwd_kernel(args[0], dy, *args[1:]))
            for name, t in by_launch.items():
                split[name] = split.get(name, 0.0) + n * t
            res['k10_bound_ms'] += n * k10_bound
            cost = block_bwd_cost(b, h, w, c)
            line += (f'; {cost[1] / ms.ms / 1e9:.1f} TFLOP/s; kernel 10 alone {k10.ms:.4f} '
                     f'({k10.eager_ms:.4f}) ms (bound {k10_bound:.4f} ms); unfused block backward '
                     f'(kernels 1, 2, LayerNorm, cuBLAS) {ums.ms:.4f} ({ums.eager_ms:.4f}) ms'
                     + add_times(res, n, ms, pms, bound_ms(*cost)))
        print(line)
        if not all(e <= 2 * p + floor for e, p in zip(err, perr)):
            fail(line)
    print(f'convnext_block_bwd, 54 blocks per KBR micro-step (B={TRAIN_B}, 384x640): block '
          f'backward (kernels 10, 1, 2) {res["ms"]:.3f} ms, bound {res["bound_ms"]:.3f} ms; plain '
          f'backward {res["plain_ms"]:.3f} ms; kernel 10 alone {res["k10_ms"]:.3f} ms, bound '
          f'{res["k10_bound_ms"]:.3f} ms; unfused block backward {res["unfused_ms"]:.3f} ms')
    print('convnext_block_bwd, kernel 10 by CUDA launch per KBR micro-step (torch.profiler device '
          'ms): ' + ', '.join(f'{k} {v:.3f}' for k, v in split.items())
          + f'; sum {sum(split.values()):.3f}')
    return res


def _photo_case(record, x, y, g, n_fwd, n_bwd):
    from slowtv_monodepth_tpu_torch.ops import photo
    xd, yd = x.double(), y.double()
    want = photo.photo_fwd_plain(xd, yd, 0.85)
    plain32 = _max_err(photo.photo_fwd_plain(x, y, 0.85), want)
    # Bytes: x, y in, the map out; g in and dx, dy out for the backward. Operations:
    # five 3x3 box statistics per channel (45 adds) and the SSIM and L1 terms,
    # about 80 per pixel and channel forward and 250 backward.
    px, pmap = x.numel(), want.numel()
    record('photo_fwd', _max_err(photo.photo_fwd(x, y, 0.85), want),
           PHOTO_ATOL + 2 * plain32, f'photo_fwd {tuple(x.shape)} (plain f32 {plain32:.2e})',
           n_fwd, lambda: photo.photo_fwd(x, y, 0.85), lambda: photo.photo_fwd_plain(x, y, 0.85),
           (4 * (2 * px + pmap), 80 * px))
    want = photo.photo_bwd_plain(xd, yd, g.double(), 0.85)
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    plain32 = max(_max_err(a, b) for a, b in zip(photo.photo_bwd_plain(x, y, g, 0.85), want))
    got = photo.photo_bwd(x, y, g, 0.85)
    if not all(torch.equal(u, v) for u, v in zip(got, photo.photo_bwd(x, y, g, 0.85))):
        fail(f'photo_bwd {tuple(x.shape)}: two calls on the same inputs differ')
    err = max(_max_err(a, b) for a, b in zip(got, want))
    plan = photo.bwd_plan(*x.shape, torch.cuda.get_device_properties(0).multi_processor_count)
    record('photo_bwd', err / scale, PHOTO_BWD_RTOL + 2 * plain32 / scale,
           f'photo_bwd {tuple(x.shape)}, tiles of {plan} rows, two calls bitwise equal '
           f'(relative to max|grad| {scale:.3g}; plain f32 {plain32 / scale:.2e})', n_bwd,
           lambda: photo.photo_bwd(x, y, g, 0.85), lambda: photo.photo_bwd_plain(x, y, g, 0.85),
           (4 * (4 * px + g.numel()), 250 * px))


def phase_train_golden(fused_blocks: bool = False) -> None:
    from slowtv_monodepth_tpu_torch import train_golden as tg
    gold = tg.load_fixture()
    got = tg.port_step(gold, 'cuda', kernels=True, fused_blocks=fused_blocks)
    rel = np.abs(got['grad_norms'] - gold['grad_norms']) / gold['grad_norms']
    print(f'train golden (ConvNeXt-B + ConvNeXt-T, B=2, 64x96'
          f'{", fused blocks" if fused_blocks else ""}): loss {got["loss"]:.7f} vs JAX '
          f'{float(gold["loss"]):.7f}; after one update {got["loss_after_update"]:.7f} vs '
          f'{float(gold["loss_after_update"]):.7f}; {len(rel)} grad norms, max rel err '
          f'{rel.max():.2e} (tol {tg.NORM_RTOL:.0e})')
    for k in tg.WHOLE:
        want = gold[f'grad:{k}']
        print(f'  grad {k}: max abs err {np.abs(got[f"grad:{k}"] - want).max():.2e} '
              f'(max |g| {np.abs(want).max():.2e})')
    if not got['grad_finite_nonzero']:
        fail('train golden: a gradient is not finite or is all zero')
    bad = tg.compare(got, gold)
    if bad:
        fail('train golden: ' + '; '.join(bad))


def _train_batch(scenes):
    """B=4 scenes, supports shifted by +-2 px along W (`bench.py`), a fixed K."""
    imgs = np.stack([scenes[i % len(scenes)] for i in range(TRAIN_B)])
    b, h, w = imgs.shape[:3]
    supp = np.stack([np.roll(imgs, 2, axis=2), np.roll(imgs, -2, axis=2)])
    K = np.array([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in
         (('imgs', imgs), ('supp_imgs', supp), ('K', np.broadcast_to(K, (b, 4, 4))))}
    return {'imgs': t['imgs'], 'supp_imgs': t['supp_imgs']}, t


def _fused_cfg(cfg: dict) -> dict:
    """`cfg` with `fused_blocks: True` on both nets."""
    return {**cfg, 'net': {k: {**v, 'fused_blocks': True} for k, v in cfg['net'].items()}}


def _build_trainer(kernels: bool, weights: dict, fused_blocks: bool = False):
    from slowtv_monodepth_tpu_torch import parsers
    from slowtv_monodepth_tpu_torch.core.trainer import MonoDepthTrainer
    cfg = _fused_cfg(KBR_TRAIN_CFG) if fused_blocks else KBR_TRAIN_CFG
    trainer = MonoDepthTrainer(cfg, kernels=kernels)
    for name, sd in weights.items():
        trainer.nets[name].load_state_dict(sd)
    trainer.to('cuda')
    opt = parsers.make_optimizer(KBR_TRAIN_CFG, trainer.nets, steps_per_epoch=1000,
                                 accumulate=KBR_TRAIN_CFG['trainer']['accumulate_grad_batches'])
    return trainer, opt, trainer.make_step_fn(SUPP_IDXS, opt)


def _time_steps(step, x, y, gen, n: int = 5) -> list[float]:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(x, y, gen)['loss'].item()  # ends in a device -> host copy
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_train(scenes, fused_blocks: bool = False) -> tuple[dict, object]:
    """The KBR step at full width: 3 updates with every launch count and every
    gradient checked, the peak memory, then micro-steps timed in turns against
    the plain path (or, with `fused_blocks`, against the unfused kernel path)."""
    from slowtv_monodepth_tpu_torch import parsers
    from slowtv_monodepth_tpu_torch.models import seeded_state_dict
    with torch.device('meta'):
        meta = parsers.get_net(KBR_TRAIN_CFG['net'])
    weights = {k: {kk: torch.from_numpy(v) for kk, v in seeded_state_dict(net, 0).items()}
               for k, net in meta.items()}
    x, y = _train_batch(scenes)
    gen = torch.Generator(device='cuda').manual_seed(0)
    want = FUSED_TRAIN_LAUNCHES if fused_blocks else TRAIN_LAUNCHES
    tag = 'train slice' + (', fused blocks' if fused_blocks else '')

    torch.cuda.reset_peak_memory_stats()
    trainer, opt, step = _build_trainer(True, weights, fused_blocks)
    totals, losses = {k: 0 for k in want}, []
    for micro in range(TRAIN_UPDATES * opt.accumulate):
        _reset_counts()
        losses.append(step(x, y, gen)['loss'].item())
        counts = _read_counts()
        totals = {k: totals[k] + counts[k] for k in totals}
        if counts != want:
            fail(f'{tag}, micro-step {micro}: launch counts {counts}, expected {want}')
        if micro == 0:  # micro-step 1's gradients, still held for the accumulation
            for name, net in trainer.nets.items():
                for k, p in net.named_parameters():
                    if p.grad is None or not bool(torch.isfinite(p.grad).all()) \
                            or not float(p.grad.abs().max()) > 0:
                        fail(f'{tag}: {name}.{k}: gradient missing, non-finite or zero')
            n_params = sum(1 for net in trainer.nets.values() for _ in net.parameters())
            print(f'{tag}: every one of {n_params} parameters of both nets has a '
                  'finite, non-zero gradient after micro-step 1')
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or opt.updates != TRAIN_UPDATES or trainer.bad_step.item() != -1:
        fail(f'{tag}: losses {losses}, updates {opt.updates}, bad_step {trainer.bad_step}')
    print(f'{tag}: KBR step, ConvNeXt-B + ConvNeXt-T, B={TRAIN_B}, 384x640, accumulate '
          f'{opt.accumulate}, {opt.updates} updates: losses {[round(v, 5) for v in losses]}; '
          f'launches per micro-step {want}; peak device memory '
          f'{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)')

    # In turns: the other path, this one, this one, the other.
    names = ('unfused', 'fused') if fused_blocks else ('plain', 'kernel')
    other = _build_trainer(kernels=fused_blocks, weights=weights)[2]  # unfused kernels, or plain
    steps = {names[0]: other, names[1]: step}
    samples = {name: [] for name in names}
    for name in (names[0], names[1], names[1], names[0]):
        _time_steps(steps[name], x, y, gen, 1)  # warm
        samples[name] += _time_steps(steps[name], x, y, gen)
    for name, ts in samples.items():
        med = float(np.median(ts))
        print(f'train micro-step {name:7s}: median {med:.2f} ms (min {min(ts):.2f}, max '
              f'{max(ts):.2f}, n={len(ts)}); {2 * med:.1f} ms per optimizer update, '
              f'{1e3 * TRAIN_B / med:.2f} images/s')
    return totals, trainer


def phase_train_to_serve(trainer, scenes) -> None:
    from slowtv_monodepth_tpu_torch.core import BenchmarkPredictor, save_checkpoint
    from slowtv_monodepth_tpu_torch.quickstart import predict
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / 'kbr_trained.ckpt'
        save_checkpoint(path, {k: net.state_dict() for k, net in trainer.nets.items()},
                        KBR_TRAIN_CFG)
        net = BenchmarkPredictor('cuda').load_model(path)
    disp = predict(net, scenes[0])
    ok = (disp.shape == scenes[0].shape[:2] and np.isfinite(disp).all()
          and 0 < disp.min() and disp.max() < 1)
    print(f'train -> serve: trained weights -> checkpoint -> BenchmarkPredictor -> predict: '
          f'disp {disp.shape} range [{disp.min():.4f}, {disp.max():.4f}] {"ok" if ok else "BAD"}')
    if not ok:
        fail('the trained checkpoint did not serve a finite (0, 1) disparity map')


# ------------------------------------------------------------------ training run
class SceneLoader:
    """In-memory stand-in for `parsers.get_dl` on the port's SlowTV dataset with
    `device_transform: true` (the card's machine has no PIL to read frames):
    batches (x, y, m) of synthetic frames with two support frames and K, where
    x holds the sampled colour-jiggle parameters only and y the raw images.
    """

    def __init__(self, scenes, n_batches: int, shape, batch: int = TRAIN_B, seed: int = 0):
        base = torch.from_numpy(np.stack(scenes)).permute(0, 3, 1, 2)
        base = torch.nn.functional.interpolate(base, size=tuple(shape), mode='bilinear',
                                               align_corners=False)
        self.base = base.permute(0, 2, 3, 1).clamp(0, 1).contiguous().numpy()
        self.n, self.batch, self.seed, self.epoch = n_batches, batch, seed, 0
        h, w = shape
        self.K = np.array([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0], [0, 0, 1, 0],
                           [0, 0, 0, 1]], np.float32)

    def __len__(self) -> int:
        return self.n

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        for i in range(self.n):
            rs = np.random.RandomState(self.seed + 1000 * self.epoch + i)
            idx = rs.randint(0, len(self.base), self.batch)
            imgs = self.base[idx]
            shift = int(rs.randint(2, 6))  # camera motion between frames, in px along W
            supp = np.stack([np.roll(imgs, shift, axis=2), np.roll(imgs, -shift, axis=2)])
            order = np.stack([rs.permutation(4) for _ in range(self.batch)]).astype(np.int32)
            factors = np.where(order == 3, rs.uniform(-0.1, 0.1, order.shape),  # op 3 is the hue
                               rs.uniform(0.8, 1.2, order.shape)).astype(np.float32)
            x = {'supp_idxs': np.array(SUPP_IDXS), 'photo_order': order, 'photo_factors': factors,
                 'photo_on': rs.rand(self.batch) < 0.5}
            y = {'imgs': imgs, 'supp_imgs': supp,
                 'K': np.ascontiguousarray(np.broadcast_to(self.K, (self.batch, 4, 4)))}
            yield x, y, {'items': [str(j) for j in idx]}


class PackLoader(SceneLoader):
    """In-memory stand-in for `parsers.get_dl` on one of the recipe's pack datasets
    (`kitti_lmdb`, `mannequin_lmdb`, `slow_tv_lmdb`; the card's machine has no PIL or
    cv2 to decode a pack): batches (x, y, m) in the layout the dataset yields with the
    recipe's settings, keys, dtypes and shapes (`tests/test_torch_recipe.py` holds them
    to the readers' batches): x the standardized frames and `supp_idxs`, y the raw
    frames, [KITTI's sparse benchmark depth at `RECIPE_DEPTH_SHAPE`] and K, m the
    readers' metadata keys.
    """

    def __init__(self, scenes, name: str, n_batches: int, shape, train: bool, seed: int = 0,
                 batch: int = TRAIN_B):
        from slowtv_monodepth_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
        super().__init__(scenes, n_batches, shape, batch=batch, seed=seed)
        self.name, self.train = name, train
        self.std = (self.base - IMAGENET_MEAN) / IMAGENET_STD

    def __iter__(self):
        from slowtv_monodepth_tpu_torch.utils import MultiLevelTimer
        for i in range(self.n):
            timer = MultiLevelTimer(name=self.name)
            with timer('Total'):
                rs = np.random.RandomState(self.seed + 1000 * self.epoch + i)
                idx = rs.randint(0, len(self.base), self.batch)
                shift = int(rs.randint(2, 6))  # camera motion between frames, in px along W

                def frames(base):
                    imgs = base[idx]
                    return imgs, np.stack([np.roll(imgs, shift, axis=2), np.roll(imgs, -shift, axis=2)])

                (x_imgs, x_supp), (imgs, supp) = frames(self.std), frames(self.base)
                x = {'imgs': x_imgs, 'supp_idxs': np.array(SUPP_IDXS), 'supp_imgs': x_supp}
                y = {'imgs': imgs, 'supp_imgs': supp}
                if self.name == 'kitti_lmdb':
                    y['depth'] = sparse_depth(rs, self.batch)
                y['K'] = np.ascontiguousarray(np.broadcast_to(self.K, (self.batch, 4, 4)))
            m = {'items': [str(j) for j in idx],
                 'items_original': [str(i * self.batch + j) for j in range(self.batch)]}
            if self.train:
                m['augs'] = [''] * self.batch
            if self.name == 'kitti_lmdb':
                m['stem'] = [f'synthetic/image_02/{j:010}' for j in idx]
            elif self.name == 'mannequin_lmdb':
                m['seq'] = ['synthetic'] * self.batch
            m.update(supp=['1'] * self.batch, timer_data=[timer.copy() for _ in idx],
                     errors=[''] * self.batch)
            yield x, y, m


class StereoHintLoader(SceneLoader):
    """In-memory stand-in for `parsers.get_dl` on `kitti_lmdb` with `dvso.yaml`'s
    datum (the card's machine cannot decode a pack): batches (x, y, m) in the layout
    the dataset yields (`tests/test_torch_families.py` holds them to the reader's): x the
    standardized frames, `supp_idxs` [0] and the stereo frame; y the raw frames,
    `T_stereo` (both signs in a batch, as the flip augmentation and the two cameras
    give them; the stereo frame shifted the way its sign says), KITTI's sparse depth at
    `RECIPE_DEPTH_SHAPE`, the proxy-depth hints at the frames' shape (~10% invalid) and K.
    """

    def __init__(self, scenes, n_batches: int, train: bool, seed: int = 0):
        from slowtv_monodepth_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
        super().__init__(scenes, n_batches, FAMILY_SHAPE, batch=FAMILY_B, seed=seed)
        self.train = train
        self.std = (self.base - IMAGENET_MEAN) / IMAGENET_STD

    def __iter__(self):
        from slowtv_monodepth_tpu_torch.utils import MultiLevelTimer
        for i in range(self.n):
            timer = MultiLevelTimer(name='kitti_lmdb')
            with timer('Total'):
                rs = np.random.RandomState(self.seed + 1000 * self.epoch + i)
                idx = rs.randint(0, len(self.base), self.batch)
                x, y = family_batch(self, idx, (0,), hints=True, rs=rs)
                y['depth'] = sparse_depth(rs, self.batch)
                y = {k: y[k] for k in ('imgs', 'T_stereo', 'supp_imgs', 'depth', 'depth_hints', 'K')}
                x = {'imgs': self.std[idx], 'supp_idxs': np.array([0]),
                     'supp_imgs': family_shift(self.std[idx], y['T_stereo'])[None]}
            m = {'items': [str(j) for j in idx]}
            if self.train:
                m['augs'] = [''] * self.batch
            m.update(stem=[f'synthetic/image_02/{j:010}' for j in idx], supp=['1'] * self.batch,
                     timer_data=[timer.copy() for _ in idx], errors=[''] * self.batch)
            yield x, y, m


def family_shift(imgs: np.ndarray, T: np.ndarray) -> np.ndarray:
    """The stereo frame of each image: 5 px along W, the way its baseline's sign says."""
    return np.stack([np.roll(im, 5 if t[0, 3] > 0 else -5, axis=1) for im, t in zip(imgs, T)])


def family_batch(loader: SceneLoader, idx, supp: tuple, hints: bool, rs) -> tuple[dict, dict]:
    """Frames `idx` of a loader's scenes with the supports `supp` (-1, 1: shifted 3 px along
    W; 0: the stereo frame), K, `T_stereo` (+-0.1 m along x, both signs) and, with `hints`,
    smooth proxy depth in [1, 80] m on 8 x 8 blocks with ~10% invalid pixels (numpy)."""
    b = len(idx)
    imgs = loader.base[idx]
    T = np.ascontiguousarray(np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)))
    T[:, 0, 3] = np.where(np.arange(b) % 2 == 0, 0.1, -0.1)
    supps = np.stack([family_shift(imgs, T) if i == 0 else np.roll(imgs, 3 * i, axis=2)
                      for i in supp])
    y = {'imgs': imgs, 'supp_imgs': supps,
         'K': np.ascontiguousarray(np.broadcast_to(loader.K, (b, 4, 4)))}
    if 0 in supp:
        y['T_stereo'] = T
    if hints:
        h, w = imgs.shape[1:3]
        d = np.kron(rs.uniform(1, 80, (b, h // 8, w // 8, 1)), np.ones((1, 8, 8, 1)))
        y['depth_hints'] = np.where(rs.rand(*d.shape) < 0.1, 0, d).astype(np.float32)
    return {'imgs': imgs, 'supp_imgs': supps}, y


def timm_state_dict(enc_name: str, seed: int) -> dict:
    """A seeded ConvNeXt state dict in timm's layout, as `api/data/export_timm.py`
    writes one: the encoder's keys at 3 input channels, and timm's classifier head
    (`head.*`), which a graft must ignore. float32, N(0, 0.02)."""
    from slowtv_monodepth_tpu_torch.models.encoders import create_encoder
    with torch.device('meta'):
        enc = create_encoder(enc_name)[0]
    rng = np.random.default_rng(seed)
    sd = {k: 0.02 * rng.standard_normal(v.shape, dtype=np.float32)
          for k, v in enc.state_dict().items()}
    c = sd['stem.1.weight'].shape[0] * 8  # the last stage's width
    sd.update({'head.norm.weight': np.ones(c, np.float32), 'head.norm.bias': np.zeros(c, np.float32),
               'head.fc.weight': 0.02 * rng.standard_normal((1000, c), dtype=np.float32),
               'head.fc.bias': np.zeros(1000, np.float32)})
    return sd


def write_timm_file(root: Path, enc_name: str, suffix: str, sd: dict) -> Path:
    """`sd` -> `<root>/timm/<enc_name><suffix>`: `.npz` by numpy, `.pth` / `.pt` by
    `torch.save` (a `.pth` wrapped in {'state_dict': ...}, as checkpoints often are)."""
    path = root / 'timm' / f'{enc_name}{suffix}'
    path.parent.mkdir(parents=True, exist_ok=True)
    if suffix == '.npz':
        np.savez(path, **sd)
    else:
        tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
        torch.save({'state_dict': tensors} if suffix == '.pth' else tensors, path)
    return path


class RunLog:
    """Writer for `MonoDepthLoop` at `log_every_n_steps: 1`: per training
    micro-step its scalars (loss, bucket shape, train metrics) as the loop logs them,
    and the time the loop's own `Step` timer gained since the step before; the
    validation scalars last logged; the image logger's grids (tag -> per epoch its
    shape, min, max and whether all finite) and text."""

    def __init__(self):
        self.loop, self.rows, self.val, self._seen = None, {}, {}, 0.0
        self.images, self.texts = {}, {}

    def add_images(self, tag: str, imgs, global_step: int) -> None:
        imgs = np.asarray(imgs)
        self.images.setdefault(global_step, {})[tag] = (
            imgs.shape, float(imgs.min()), float(imgs.max()), bool(np.isfinite(imgs).all()))

    def add_text(self, tag: str, text: str, global_step: int) -> None:
        self.texts.setdefault(global_step, {})[tag] = text

    def add_scalar(self, tag: str, val: float, step: int) -> None:
        if tag.startswith('val_'):
            self.val[tag.split('/')[-1]] = val
        if not tag.startswith('train_'):
            return
        self.rows.setdefault(step, {})[tag.split('/')[-1]] = val
        if tag == 'train_losses/loss':
            total = self.loop.timer.total_elapsed()['Step']
            self.rows[step]['ms'], self._seen = total - self._seen, total

    def steps(self) -> list:
        """(global step, (height, width), ms, loss) per logged micro-step."""
        return [(n, (int(r['height']), int(r['width'])), r['ms'], r['loss'])
                for n, r in sorted(self.rows.items())]


def _run_loop(cfg: dict, ckpt_dir: Path, scenes, val: bool, tag: str,
              n_batches: int = RUN_BATCHES, loaders=None, before_fit=None, heavy_logger=None):
    """One `MonoDepthLoop.fit()` over `SceneLoader`s (or over `loaders`, a (train,
    val) pair) -> (loop, stats): the launch counts of the fit, each micro-step's
    (bucket, ms, loss), the logged scalars and images and the wall time.
    `before_fit(loop)` runs just before the fit."""
    from slowtv_monodepth_tpu_torch.core import MonoDepthLoop
    log = RunLog()
    if loaders is None:
        loaders = (SceneLoader(scenes, n_batches, RUN_SRC_SHAPE, seed=RUN_SEED),
                   SceneLoader(scenes, 1, (384, 640), seed=RUN_SEED + 1) if val else None)
    n_batches = len(loaders[0])
    loop = log.loop = MonoDepthLoop(cfg, ckpt_dir, writer=log, train_dl=loaders[0],
                                    val_dl=loaders[1], heavy_logger=heavy_logger)
    loop.sync_timers = True  # each stage of the epoch waits for the device: a true split
    if before_fit is not None:
        before_fit(loop)
    _reset_counts()
    t0 = time.perf_counter()
    loop.fit()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    logged = log.steps()
    epochs = loop.max_epochs - loop.start_epoch
    if [n for n, *_ in logged] != list(range(loop.global_step - epochs * n_batches + 1,
                                             loop.global_step + 1)):
        fail(f'run {tag}: logged micro-steps {[n for n, *_ in logged]}, ended at '
             f'{loop.global_step} after {epochs} epoch(s) of {n_batches}')
    steps = [row[1:] for row in logged]
    start = {'epoch': loop.start_epoch, 'step': logged[0][0] - 1}
    stats = {'counts': _read_counts(), 'steps': steps, 'wall_ms': wall, 'start': start,
             'split': loop.timer.total_elapsed(), 'rows': log.rows, 'val': log.val,
             'images': log.images, 'texts': log.texts}
    losses = [l for _, _, l in steps]
    if not (losses and all(np.isfinite(losses))) or int(loop.trainer.bad_step) != -1:
        fail(f'run {tag}: losses {losses}, bad_step {loop.trainer.bad_step}')
    if not (ckpt_dir / 'finished').is_file() or list(ckpt_dir.glob('training_*')) \
            or not (ckpt_dir / 'last.ckpt').is_file():
        fail(f'run {tag}: markers or last.ckpt wrong in {sorted(p.name for p in ckpt_dir.iterdir())}')
    per_bucket = {}
    for shape, ms, _ in steps:
        per_bucket.setdefault(shape, []).append(ms)
    print(f'run {tag}: epoch(s) {start["epoch"]}..{loop.max_epochs - 1}, micro-steps '
          f'{start["step"] + 1}..{loop.global_step}, now at update {loop.opt.updates}, losses '
          f'{[round(l, 4) for l in losses]}')
    repeats = [t for ts in per_bucket.values() for t in ts[1:]]
    stats['median_ms'] = float(np.median([ms for _, ms, _ in steps]))
    stats['repeat_median_ms'] = float(np.median(repeats)) if repeats else float('nan')
    print(f'run {tag}: micro-step ms per bucket (the first use of a shape in a process includes '
          'cuDNN autotuning and new allocations): '
          + ', '.join(f'{h}x{w}: {"/".join(format(t, ".0f") for t in ts)}'
                      for (h, w), ts in per_bucket.items())
          + f'; median {stats["median_ms"]:.1f} ms, of the {len(repeats)} repeat uses '
          f'{stats["repeat_median_ms"]:.1f} ms')
    split = stats['split']
    print(f'run {tag}: fit wall {wall:.0f} ms = ' + ', '.join(
        f'{k} {v:.0f} ms' for k, v in split.items())
        + f', other {wall - sum(split.values()):.0f} ms (stages synchronized)')
    return loop, stats


def _expected_run_counts(n: int, v: int, warp_bf16: bool = False, depth_batches: int = 0) -> dict:
    """Launches of `n` training micro-steps on sources off the reference shape (every
    batch is resampled, 4 tensors each: x and y, imgs and supp_imgs, and the depth of
    `depth_batches` of them one more) and `v` validation steps."""
    step_warp = {'warp_packed' if warp_bf16 else 'warp': n + v}
    counts = {'dwconv': 108 * n + 54 * v, 'decoder_stage': 2 * (n + v), 'decoder_stage_bwd': 2 * n,
              'dwconv_dw': 54 * n, 'warp': 0, 'warp_packed': 0, 'photo_fwd': 2 * (n + v),
              'photo_bwd': n, 'convnext_block': 0, 'convnext_block_bwd': 0}
    counts.update(step_warp)
    counts['warp'] += 4 * n + depth_batches
    return counts


def phase_run(scenes) -> dict:
    """The KBR training run: fit, resume, serve; then 'high' matmuls and the bf16 warp."""
    from slowtv_monodepth_tpu_torch.core import BenchmarkPredictor
    from slowtv_monodepth_tpu_torch.quickstart import predict
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp) / 'run'
        loop, first = _run_loop(RUN_CFG, run, scenes, val=True, tag="float32 'highest'")
        want = _expected_run_counts(RUN_BATCHES, 1)
        if first['counts'] != want:
            fail(f'run: launch counts {first["counts"]}, expected {want}')
        buckets = {s for s, _, _ in first['steps']}
        if loop.opt.updates != RUN_BATCHES // 2 or len(buckets) < 3 \
                or not buckets >= {b for _, b in run_buckets()} or not (run / 'best.ckpt').is_file():
            fail(f'run: updates {loop.opt.updates}, buckets {buckets}, files '
                 f'{sorted(p.name for p in run.iterdir())}')
        print(f'run: launches over the epoch {first["counts"]} (as expected), {len(buckets)} '
              f'aspect-ratio buckets, last.ckpt {(run / "last.ckpt").stat().st_size / 2**20:.0f} MiB')
        launches = first['counts']

        (run / 'finished').unlink()  # a finished run refuses a second start; ask for one more epoch
        cfg2 = {**RUN_CFG, 'trainer': {**RUN_CFG['trainer'], 'max_epochs': 2}}
        loop2, second = _run_loop(cfg2, run, scenes, val=True, tag='resumed')
        # One more epoch of 4 updates: the counts go on from the checkpoint's, not from 0.
        if second['start'] != {'epoch': 1, 'step': RUN_BATCHES} \
                or loop2.opt.updates != 2 * loop.opt.updates or loop2.ckpt.best is None:
            fail(f'run: the second loop started at {second["start"]}, ended at update '
                 f'{loop2.opt.updates}, best {loop2.ckpt.best}')
        print(f'run: resumed at epoch 1 after micro-step {second["start"]["step"]} and update '
              f'{loop.opt.updates}; now at update {loop2.opt.updates}')
        del loop, loop2
        net = BenchmarkPredictor('cuda').load_model(run / 'last.ckpt')
        disp = predict(net, scenes[0])
        if not (disp.shape == scenes[0].shape[:2] and np.isfinite(disp).all()
                and 0 < disp.min() and disp.max() < 1):
            fail('run: last.ckpt did not serve a finite (0, 1) disparity map')
        print(f'run -> serve: last.ckpt -> BenchmarkPredictor -> predict: disp {disp.shape} range '
              f'[{disp.min():.4f}, {disp.max():.4f}] ok')
        del net

    # The recipe's own matmul precision (TF32 GEMMs; cuDNN convs stay exact), on
    # the same batches and buckets, now warm in cuDNN's autotuner.
    with tempfile.TemporaryDirectory() as tmp:
        cfg = {**RUN_CFG, 'trainer': {**RUN_CFG['trainer'], 'matmul': 'high'}}
        _, high = _run_loop(cfg, Path(tmp) / 'run', scenes, val=False, tag="float32 'high'",
                            n_batches=RUN_LONG_BATCHES)
        if torch.get_float32_matmul_precision() != 'high':
            fail("run: trainer.matmul 'high' did not reach torch")
        if high['counts'] != _expected_run_counts(RUN_LONG_BATCHES, 0):
            fail(f"run 'high': launch counts {high['counts']}")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = {**RUN_CFG, 'trainer': {**RUN_CFG['trainer'], 'warp_bf16': True}}
        _, bf16 = _run_loop(cfg, Path(tmp) / 'run', scenes, val=False, tag='bf16 warp sources',
                            n_batches=RUN_LONG_BATCHES)
        want = _expected_run_counts(RUN_LONG_BATCHES, 0, warp_bf16=True)
        if bf16['counts'] != want:
            fail(f'run bf16: launch counts {bf16["counts"]}, expected {want}')
        launches = {**launches, 'warp_packed': bf16['counts']['warp_packed']}
    a, b = first['steps'][0][2], bf16['steps'][0][2]
    print(f'run bf16: warp_packed {want["warp_packed"]} launches (one per micro-step), kernel 5 '
          f'{want["warp"]} (the augmentation only); first-step loss {b:.6f} vs float32 {a:.6f}, '
          f'relative difference {abs(a - b) / a:.1e} (tol {BF16_LOSS_RTOL:.0e})')
    if not abs(a - b) <= BF16_LOSS_RTOL * a:
        fail('run bf16: the first-step loss is off the float32 run')
    print(f"run: micro-step medians: 'highest' (first epoch of the process, {RUN_BATCHES} batches) "
          f"{first['median_ms']:.1f} ms; over the same {RUN_LONG_BATCHES} batches 'high' "
          f"{high['median_ms']:.1f} ms (repeat uses {high['repeat_median_ms']:.1f} ms) and "
          f"'highest' with bf16 warp sources {bf16['median_ms']:.1f} ms (repeat uses "
          f"{bf16['repeat_median_ms']:.1f} ms)")

    # Both settings are process-global: put them back for whatever runs next.
    torch.set_float32_matmul_precision('highest')
    torch.backends.cudnn.benchmark = False
    if torch.get_float32_matmul_precision() != 'highest' or torch.backends.cuda.matmul.allow_tf32 \
            or torch.backends.cudnn.allow_tf32:
        fail('run: float32 matmul precision is not back at highest')
    print("run: float32 matmul precision back at 'highest', cudnn.benchmark off")
    return launches


def np_train_metrics(pred: np.ndarray, target: np.ndarray, min_depth: float,
                     max_depth: float) -> dict:
    """`core.train_metrics.compute_train_metrics` restated in float64 numpy, row by row:
    `numpy.median` over the valid entries, the legacy `Acc` denominator (the sum of
    the ratios over the valid pixels, not their count)."""
    rows = []
    for p, t in zip(pred.reshape(len(pred), -1).astype(np.float64),
                    target.reshape(len(target), -1).astype(np.float64)):
        p = np.clip(p, min_depth, max_depth)
        valid = (t > min_depth) & (t < max_depth)
        r = np.median(t[valid]) / np.median(p[valid]) if valid.any() else 1.0
        p, t = np.clip(p * r, min_depth, max_depth)[valid], np.clip(t, min_depth, max_depth)[valid]
        n = max(int(valid.sum()), 1)
        err, log_err = p - t, np.log(p) - np.log(t)
        thresh = np.maximum(t / p, p / t)
        rows.append((np.abs(err).sum() / n, np.sqrt((err ** 2).sum() / n),
                     np.sqrt(max((log_err ** 2).sum() / n - (log_err.sum() / n) ** 2, 0.0)),
                     (np.abs(err) / t).sum() / n, (thresh < 1.25).sum() / max(thresh.sum(), 1.0)))
    mae, rmse, log_si, abs_rel, acc = np.mean(rows, axis=0)
    return {'MAE': mae, 'RMSE': rmse, 'LogSI': 100 * log_si, 'AbsRel': 100 * abs_rel,
            'Acc': 100 * acc}


def phase_recipe(scenes) -> None:
    """`cfg/kbr/default.yaml` as it stands: one epoch of `MonoDepthLoop` over a
    `ConcatDataLoader` of the recipe's three pack datasets, in its key order, at their
    published shapes (`PackLoader`s): 6 micro-steps (3 updates) with aspect-ratio
    augmentation, KITTI's sparse depth resampled with its images, and the train
    metrics against it; then a validation batch of each dataset."""
    from slowtv_monodepth_tpu_torch.core.train_metrics import METRIC_NAMES
    from slowtv_monodepth_tpu_torch.data import ConcatDataLoader
    from slowtv_monodepth_tpu_torch.ops import resize_like

    def loaders(train: bool):
        return ConcatDataLoader([
            PackLoader(scenes, name, RECIPE_TRAIN_BATCHES if train else 1,
                       src if train else val, train, seed=RUN_SEED + 10 * i + 5 * (not train))
            for i, (name, (src, val)) in enumerate(RECIPE_DATASETS.items())])

    captured = []

    def record_first_metrics(loop):
        """Keep the finest depth, the target and the metrics of the first micro-step
        with a depth target (the first KITTI batch)."""
        scalars = loop.trainer.scalars

        def recording(loss, loss_dict, fwd, y):
            out = scalars(loss, loss_dict, fwd, y)
            if 'depth' in y and not captured:
                pred = resize_like(fwd['depth_up'][min(fwd['depth_up'])], y['depth'])
                captured.append((pred.detach().double().cpu().numpy(), y['depth'].double().cpu().numpy(),
                                 {k: float(out[k]) for k in METRIC_NAMES}))
            return out

        loop.trainer.scalars = recording

    t0 = time.perf_counter()
    n = len(RECIPE_DATASETS) * RECIPE_TRAIN_BATCHES
    with tempfile.TemporaryDirectory() as tmp:
        loop, st = _run_loop(RUN_CFG, Path(tmp) / 'run', scenes, val=True, tag='recipe',
                             loaders=(loaders(True), loaders(False)), before_fit=record_first_metrics)
    want = _expected_run_counts(n, len(RECIPE_DATASETS), depth_batches=RECIPE_TRAIN_BATCHES)
    if st['counts'] != want:
        fail(f'recipe: launch counts {st["counts"]}, expected {want}')
    names = list(RECIPE_DATASETS) * RECIPE_TRAIN_BATCHES  # the round robin: depth on 0 and 3
    for (step, row), (shape, ms, loss), name in zip(sorted(st['rows'].items()), st['steps'], names):
        metrics = {k: row[k] for k in METRIC_NAMES if k in row}
        print(f'recipe micro-step {step} ({name}, source {RECIPE_DATASETS[name][0][0]}x'
              f'{RECIPE_DATASETS[name][0][1]}): bucket {shape[0]}x{shape[1]}, {ms:.0f} ms, loss '
              f'{loss:.4f}' + ''.join(f', {k} {v:.4g}' for k, v in metrics.items()))
        if bool(metrics) != (name == 'kitti_lmdb') or not all(np.isfinite(list(metrics.values()))) \
                or (metrics and len(metrics) != len(METRIC_NAMES)):
            fail(f'recipe micro-step {step} ({name}): train metrics {metrics}, expected them '
                 'on the KITTI batches (0 and 3) only')
    if kitti_bucket()[1] not in {shape for shape, _, _ in st['steps']} or loop.opt.updates != n // 2:
        fail(f'recipe: buckets {[shape for shape, _, _ in st["steps"]]}, updates {loop.opt.updates}')
    val = {k: st['val'].get(k) for k in ('loss',) + METRIC_NAMES}
    if not all(v is not None and np.isfinite(v) for v in val.values()):
        fail(f'recipe: validation scalars {val}')
    print(f'recipe: launches {st["counts"]} (as expected: the depth of each KITTI batch is one '
          f'more kernel 5 launch at C = 1); validation over one batch each (KITTI at 192x640 with '
          f'its depth): ' + ', '.join(f'{k} {v:.4g}' for k, v in val.items()))

    pred, target, got = captured[0]
    ref = np_train_metrics(pred, target, *(RUN_CFG['trainer'][k] for k in ('min_depth', 'max_depth')))
    rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in METRIC_NAMES}
    line = (f'recipe: train metrics of the first KITTI micro-step (pred {pred.shape}, '
            f'{int((target > 0).sum())} valid depths) against float64 numpy: ' + ', '.join(
                f'{k} {got[k]:.6g} vs {ref[k]:.6g} (rel {rel[k]:.1e})' for k in METRIC_NAMES)
            + f' (tol {METRICS_RTOL:.0e})')
    print(line)
    if not all(r <= METRICS_RTOL for r in rel.values()):
        fail(line)
    torch.backends.cudnn.benchmark = False
    if torch.get_float32_matmul_precision() != 'highest':
        fail('recipe: float32 matmul precision is not at highest')
    print(f'recipe: phase wall {time.perf_counter() - t0:.1f} s (the loop built, fit, checked)')


def _flat_tensors(tree, pre: str = '') -> dict:
    """Every tensor of a nested dict / list by its path."""
    if isinstance(tree, torch.Tensor):
        return {pre: tree}
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (list, tuple)) else ()
    out = {}
    for k, v in items:
        out.update(_flat_tensors(v, f'{pre}.{k}'))
    return out


def _host_state(loop) -> dict:
    """A host copy of every tensor of the loop's training state: nets and optimizer."""
    nets = {k: net.state_dict() for k, net in loop.trainer.nets.items()}
    return {k: v.detach().cpu().clone() for k, v in
            _flat_tensors({'state_dict': nets, 'optimizer': loop.opt.state_dict()}).items()}


def _file_state(path: Path) -> dict:
    """The same paths for a training checkpoint file (nets under `nets.<name>.`)."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    nets = {}
    for k, v in ckpt['state_dict'].items():
        name, key = k[len('nets.'):].split('.', 1)
        nets.setdefault(name, {})[key] = v
    return _flat_tensors({'state_dict': nets, 'optimizer': ckpt['optimizer']})


def _published_fit(scenes, run: Path, sds: dict, async_ckpt: bool) -> dict:
    """`MonoDepthLoop` on the KBR cfg from the pretrained files, with the image
    logger, `A7B_EPOCHS` epochs of `A7B_BATCHES` -> what `phase_published_run` checks."""
    from slowtv_monodepth_tpu_torch.core import HeavyLogger

    class CountingLogger(HeavyLogger):
        """The image logger, with each call's seconds and kernel launches."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.runs = []

        def log_step(self, *args, **kwargs):
            before, t0 = _read_counts(), time.perf_counter()
            super().log_step(*args, **kwargs)
            torch.cuda.synchronize()
            after = _read_counts()
            self.runs.append({'s': time.perf_counter() - t0,
                              'counts': {k: after[k] - before[k] for k in after}})

    logger = CountingLogger(n_imgs=6, n_cols=2)
    out = {'graft_faults': [], 'file_faults': None}
    tag = 'async' if async_ckpt else 'sync'

    def before_fit(loop):
        for key, sd in sds.items():  # the grafted weights, before any update
            got = {k: v.cpu() for k, v in loop.trainer.nets[key].encoder.state_dict().items()}
            want = {k: torch.from_numpy(v) for k, v in sd.items() if not k.startswith('head.')}
            if key == 'pose':  # the 6-channel stem: tiled, scaled by 3 / 6
                w = sd['stem.0.weight']
                want['stem.0.weight'] = torch.from_numpy(np.concatenate([w, w], 1) * np.float32(0.5))
            if sorted(got) != sorted(want):
                out['graft_faults'].append(f'{key}: keys differ')
            out['graft_faults'] += [f'{key}.{k}' for k in want if k in got and not torch.equal(got[k], want[k])]
        save, train_epoch = loop.ckpt.step, loop.train_epoch

        def checked_save(nets, opt, cfg, epoch, step, metrics):
            if epoch == 1:  # epoch 0's last.ckpt, written while epoch 1 trained
                loop.ckpt.finalize()
                on_disk = _file_state(run / 'last.ckpt')
                out['file_faults'] = ([k for k, v in out['at_save'].items()
                                       if not (k in on_disk and torch.equal(on_disk[k], v))]
                                      + sorted(set(on_disk) - set(out['at_save'])))
                out['n_tensors'] = len(on_disk)
            if epoch == 0:
                out['at_save'] = _host_state(loop)
            before = torch.cuda.memory_allocated()
            save(nets, opt, cfg, epoch, step, metrics)
            out.setdefault('held', []).append(torch.cuda.memory_allocated() - before)

        def watched_epoch(epoch):
            saver = loop.ckpt.saver
            out.setdefault('in_flight', []).append(
                saver is not None and saver._thread is not None and saver._thread.is_alive())
            if epoch == 1:  # the peak from here on: epoch 1 trains beside epoch 0's write
                out['peak_epoch0'] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            train_epoch(epoch)

        loop.ckpt.step, loop.train_epoch = checked_save, watched_epoch

    # cuDNN's autotuner off: its workspaces for new buckets would hide the snapshot's
    # memory in the peaks (the first of the two runs meets the buckets first).
    cfg = {**RUN_CFG, 'trainer': {**RUN_CFG['trainer'], 'max_epochs': A7B_EPOCHS,
                                  'async_ckpt': async_ckpt, 'benchmark': False}}
    gc.collect()  # earlier phases' garbage off the card: the peaks are this fit's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loop, st = _run_loop(cfg, run, scenes, val=True, tag=f'published ({tag} checkpoints)',
                         n_batches=A7B_BATCHES, before_fit=before_fit, heavy_logger=logger)
    out.update(st=st, runs=logger.runs, peak_epoch1=torch.cuda.max_memory_allocated(),
               updates=loop.opt.updates)
    out['peak'] = max(out['peak_epoch0'], out['peak_epoch1'])
    del loop
    torch.cuda.empty_cache()
    return out


def phase_published_run(scenes) -> None:
    """The published recipe's run as the JAX package's entry point runs it: both
    encoders from pretrained files, the image logger at each epoch's end, and
    `last` / `best` saved in the background (`trainer.async_ckpt`)."""
    from slowtv_monodepth_tpu_torch import paths
    from slowtv_monodepth_tpu_torch.core import trainer as trainer_mod
    t_phase = time.perf_counter()
    encs = {k: KBR_TRAIN_CFG['net'][k]['enc_name'] for k in ('depth', 'pose')}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / 'models'
        t0 = time.perf_counter()
        sds = {key: timm_state_dict(encs[key], seed=7 + i) for i, key in enumerate(encs)}
        for key, suffix in (('depth', '.npz'), ('pose', '.pth')):
            write_timm_file(root, encs[key], suffix, sds[key])
        size = sum(f.stat().st_size for f in (root / 'timm').iterdir())
        print(f'published run: seeded timm-layout files {sorted(p.name for p in (root / "timm").iterdir())}'
              f' ({size / 2**20:.0f} MiB, head.* included) written in {time.perf_counter() - t0:.1f} s')
        roots, load = paths.MODEL_ROOTS, trainer_mod.load_pretrained_encoder
        graft_s = []

        def timed_load(*args, **kwargs):
            t = time.perf_counter()
            found = load(*args, **kwargs)
            graft_s.append(time.perf_counter() - t)
            return found

        paths.MODEL_ROOTS, trainer_mod.load_pretrained_encoder = [root] + list(roots), timed_load
        try:
            fits = {mode: _published_fit(scenes, Path(tmp) / mode, sds, mode == 'async')
                    for mode in ('sync', 'async')}
        finally:
            paths.MODEL_ROOTS, trainer_mod.load_pretrained_encoder = roots, load
    del sds
    print(f'published run: pretrained graft at init (depth, pose) per loop: '
          f'{", ".join(f"{t * 1e3:.0f} ms" for t in graft_s)}')

    n = A7B_BATCHES * A7B_EPOCHS
    want = _expected_run_counts(n, A7B_EPOCHS)
    want = {k: v + A7B_EPOCHS * RERUN_LAUNCHES.get(k, 0) for k, v in want.items()}
    for mode, fit in fits.items():
        st = fit['st']
        if fit['graft_faults']:
            fail(f'published run ({mode}): encoder tensors not the files\': {fit["graft_faults"][:5]}')
        if st['counts'] != want or fit['updates'] != n // 2:
            fail(f'published run ({mode}): launch counts {st["counts"]}, expected {want}; '
                 f'updates {fit["updates"]}')
        for run in fit['runs']:
            if {k: v for k, v in run['counts'].items() if v} != RERUN_LAUNCHES:
                fail(f'published run ({mode}): the image logger launched {run["counts"]}, '
                     f'expected {RERUN_LAUNCHES}')
        if sorted(st['images']) != list(range(A7B_EPOCHS)) or len(fit['runs']) != A7B_EPOCHS:
            fail(f'published run ({mode}): images logged at steps {sorted(st["images"])}')
        for epoch, grids in st['images'].items():
            tags = {t[len('train_'):] for t in grids}
            if tags != HEAVY_TAGS or 'train_items' not in st['texts'].get(epoch, {}):
                fail(f'published run ({mode}), epoch {epoch}: image tags {sorted(tags)}, expected '
                     f'{sorted(HEAVY_TAGS)}; texts {sorted(st["texts"].get(epoch, {}))}')
            bad = [t for t, (shape, lo, hi, finite) in grids.items()
                   if not (len(shape) == 4 and shape[:2] == (1, 3) and finite and 0 <= lo and hi <= 1)]
            if bad:
                fail(f'published run ({mode}), epoch {epoch}: grids not (1, 3, H, W) finite in [0, 1]: '
                     f'{bad}')
        print(f'published run ({mode}): graft held (every depth-encoder tensor the .npz\'s, the pose '
              f'stem the 6-channel adaptation, every other pose tensor the .pth\'s); launches {st["counts"]} '
              f'(as expected, with the image logger\'s rerun); image logger per epoch: '
              + ', '.join(f'{r["s"]:.2f} s' for r in fit['runs'])
              + f', launches {RERUN_LAUNCHES}, {len(HEAVY_TAGS)} grids, e.g. pred/disp '
              f'{st["images"][0]["train_pred/disp"][0]}; peak device memory '
              f'{fit["peak"] / 2**30:.2f} GiB')
    for mode, fit in fits.items():
        if fit['file_faults'] is None or fit['file_faults']:
            fail(f'published run ({mode}): epoch 0\'s last.ckpt differs from the state at its save: '
                 f'{(fit["file_faults"] or [None])[:5]}')
    a = fits['async']
    print(f'published run (async): epoch 0\'s last.ckpt ({a["n_tensors"]} tensors, optimizer moments '
          f'included) equals bitwise the host copy taken at its save; a save in flight at the start '
          f'of epochs {a["in_flight"]}')
    split = {mode: fit['st']['split'] for mode, fit in fits.items()}
    print('published run: Checkpoint timer (ms, both epochs) sync '
          f'{split["sync"]["Checkpoint"]:.1f} async {split["async"]["Checkpoint"]:.1f}; fit wall (ms) '
          f'sync {fits["sync"]["st"]["wall_ms"]:.1f} async {fits["async"]["st"]["wall_ms"]:.1f}; '
          'device memory held on return from each epoch\'s save (MiB) sync '
          f'{[round(b / 2**20, 1) for b in fits["sync"]["held"]]} async '
          f'{[round(b / 2**20, 1) for b in fits["async"]["held"]]}; peak device memory (GiB) over '
          f'epoch 1 (beside epoch 0\'s write when async) sync {fits["sync"]["peak_epoch1"] / 2**30:.3f} '
          f'async {fits["async"]["peak_epoch1"] / 2**30:.3f}, over the fit sync '
          f'{fits["sync"]["peak"] / 2**30:.3f} async {fits["async"]["peak"] / 2**30:.3f}; epoch 1\'s '
          'micro-steps (ms) sync ' + ', '.join(f'{ms:.0f}' for _, ms, _ in fits['sync']['st']['steps'][A7B_BATCHES:])
          + ' async ' + ', '.join(f'{ms:.0f}' for _, ms, _ in fits['async']['st']['steps'][A7B_BATCHES:]))
    print(f'published run: phase wall {time.perf_counter() - t_phase:.1f} s')


def phase_optimizers(scenes) -> None:
    """One update (two micro-steps) of the KBR step at full width with each optimizer
    the JAX package builds besides AdamW: a finite loss, every parameter moved, and
    the card's update equal to the same optimizer's on CPU copies with the same
    averaged gradients (to OPT_RTOL of each tensor's largest magnitude)."""
    from slowtv_monodepth_tpu_torch import parsers
    from slowtv_monodepth_tpu_torch.core.trainer import MonoDepthTrainer
    from slowtv_monodepth_tpu_torch.models import seeded_state_dict
    t_phase = time.perf_counter()
    trainer = MonoDepthTrainer({**KBR_TRAIN_CFG, 'net': {
        k: {**v, 'pretrained': False} for k, v in KBR_TRAIN_CFG['net'].items()}})
    weights = {k: {kk: torch.from_numpy(v) for kk, v in seeded_state_dict(net, 0).items()}
               for k, net in trainer.nets.items()}
    trainer.to('cuda')
    x, y = _train_batch(scenes)
    gen = torch.Generator(device='cuda').manual_seed(0)
    for name, ocfg in OPTIMIZER_CFGS.items():
        for key, sd in weights.items():
            trainer.nets[key].load_state_dict(sd)
        trainer.step_count = trainer.bad_step = None
        opt = parsers.make_optimizer({**KBR_TRAIN_CFG, 'optimizer': ocfg}, trainer.nets,
                                     steps_per_epoch=1000, accumulate=2)
        seen, inner = {}, opt.opt.step

        def recording_step(opt=opt, inner=inner, seen=seen):
            groups = opt.opt.param_groups
            seen['groups'] = [{k: v for k, v in g.items() if k != 'params'} for g in groups]
            seen['p0'] = [[p.detach().cpu().clone() for p in g['params']] for g in groups]
            seen['g'] = [[p.grad.detach().cpu().clone() for p in g['params']] for g in groups]
            return inner()

        opt.opt.step = recording_step
        step = trainer.make_step_fn(SUPP_IDXS, opt)
        losses = [step(x, y, gen)['loss'].item() for _ in range(2)]
        card = [[p.detach().cpu() for p in g['params']] for g in opt.opt.param_groups]
        cpu_groups = [{**g, 'params': [torch.nn.Parameter(p.clone()) for p in p0]}
                      for g, p0 in zip(seen['groups'], seen['p0'])]
        for g, grads in zip(cpu_groups, seen['g']):
            for p, grad in zip(g['params'], grads):
                p.grad = grad
        t0 = time.perf_counter()
        type(opt.opt)(cpu_groups, lr=seen['groups'][0]['lr']).step()
        cpu_s = time.perf_counter() - t0
        worst, unmoved, n, still = 0.0, 0, 0, []
        for g, p0s, ps in zip(cpu_groups, seen['p0'], card):
            for want, p0, got in zip(g['params'], p0s, ps):
                want = want.detach()
                worst = max(worst, float((got - want).abs().max() / want.abs().max()))
                unmoved += bool(torch.equal(got, p0))
                if torch.equal(want, p0):  # an update under half an ulp of every element
                    still.append(round(float(p0.abs().min()), 4))
                n += 1
        line = (f'optimizer {name} {ocfg}: KBR step B={TRAIN_B}, 384x640, 1 update: losses '
                f'{[round(v, 5) for v in losses]}; {n - unmoved} of {n} parameters moved on the '
                f'card, {n - len(still)} on the CPU (min |p| of those that stayed: {still}); '
                f'card vs CPU update max err {worst:.2e} of each '
                f'tensor\'s largest magnitude (tol {OPT_RTOL:.0e}); CPU reference update {cpu_s:.1f} s')
        print(line)
        # SGD's update is lr times the gradient: where that is under half an ulp of every
        # element (LayerNorm scales near 1), float32 keeps the parameter on both sides.
        if not (all(np.isfinite(losses)) and opt.updates == 1 and worst <= OPT_RTOL
                and unmoved == len(still) and (unmoved == 0 or name == 'sgd')):
            fail(line)
    del trainer
    torch.cuda.empty_cache()
    print(f'optimizers: phase wall {time.perf_counter() - t_phase:.1f} s')


def phase_train_dev(scenes) -> None:
    """`train_dev.DevLoop` (`slowtv-train-dev-torch`) at full width: 1 epoch x 2 batches."""
    from slowtv_monodepth_tpu_torch.train_dev import DevLoop
    cfg = {**RUN_CFG, 'trainer': {**RUN_CFG['trainer'], 'max_epochs': 1, 'resume_training': False}}
    with tempfile.TemporaryDirectory() as tmp:
        loop = DevLoop(cfg, Path(tmp) / 'dev', use_markers=False, limit_batches=2,
                       train_dl=SceneLoader(scenes, 4, RUN_SRC_SHAPE, seed=RUN_SEED))
        _reset_counts()
        t0 = time.perf_counter()
        loop.fit()
        wall = time.perf_counter() - t0
        ok = loop.global_step == 2 and (Path(tmp) / 'dev' / 'last.ckpt').is_file()
    counts, want = _read_counts(), _expected_run_counts(2, 0)
    print(f'train_dev: DevLoop 1 epoch x 2 batches (of 4), losses checked every step: '
          f'{loop.global_step} micro-steps, launches {counts}, {wall:.1f} s')
    if not ok or counts != want:
        fail(f'train_dev: micro-steps {loop.global_step}, launches {counts}, expected {want}')


# ------------------------------------------------------------------ evaluation
def eval_targets(cfg_name: str, n: int, shapes, density: float, seed: int) -> dict:
    """Synthetic targets of an eval cfg as `export_gt` writes them (`targets_test.npz`),
    at the sources' full size: depth (a ground plane rising to the horizon, objects,
    `density` of the pixels measured, the rest 0) and K (not for the datasets without
    intrinsics, `NO_K_CFGS`); SYNS-Patches also its edge maps
    and categories; KITTI's depths an object array (the drives' sizes differ)."""
    rs = np.random.RandomState(seed)
    depths, Ks, edges = [], [], []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        v = np.linspace(1, 0, h)[:, None]
        depth = 1.5 + 60 * v ** 2 + 40 * (np.arange(w)[None] % (97 + 13 * i) < 20) * v
        depth = (depth * (1 + 0.02 * rs.rand(h, w))).astype(np.float32)
        depth[rs.rand(h, w) >= density] = 0
        depths.append(depth)
        if cfg_name in NO_K_CFGS:
            pass
        elif cfg_name.startswith('kitti'):
            Ks.append(np.array([[721.5377, 0, 609.5593], [0, 721.5377, 172.854], [0, 0, 1]],
                               np.float32))
        else:
            Ks.append(np.array([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0],
                                [0, 0, 1, 0], [0, 0, 0, 1]], np.float32))
        if cfg_name == 'syns_test':
            edge = np.zeros((h, w), bool)
            edge[:, np.arange(w) % (97 + 13 * i) == 20] = True
            edge[h // 2] = True
            edges.append(edge)
    data = {'depth': (np.array(depths, dtype=object) if len({d.shape for d in depths}) > 1
                      else np.stack(depths))}
    if Ks:
        data['K'] = np.stack(Ks)
    if edges:
        data.update(edge=np.stack(edges),
                    cat=np.array([('Natural', 'Urban')[i % 2] for i in range(n)]),
                    subcat=np.array([('Woodland', 'Park')[i % 2] for i in range(n)]))
    return data


class EvalStandIn:
    """In-memory stand-in for an evaluation dataset as `export_preds.make_dataset`
    builds it (datum 'image', at the predictor's input shape; the card's machine has
    no PIL to decode the files): items (x, y, m) with x the standardized image, y
    the raw one, m the dataset's metadata keys, collated as the dataset collates;
    and `targets[cfg]`, the exported targets of each eval cfg it serves.
    `tests/test_torch_eval_api.py` holds both layouts to the real datasets'."""

    META = {'syns_patches': {'cat': 'Natural', 'subcat': 'Woodland'},
            'kitti': {'stem': '2011_09_26/2011_09_26_drive_0002_sync/image_02/0000000069'},
            'mannequin': {'seq': '00c2a6b1bcb0fb9e'},
            'ddad': {}, 'diode': {}, 'nyud': {}, 'sintel': {}, 'tum': {}}

    def __init__(self, scenes, name: str, n: int = EVAL_ITEMS, seed: int = 0):
        self._frames(scenes, name, n)
        shapes, densities = EVAL_SETS[name]
        self.targets = {cfg: eval_targets(cfg, n, shapes, d, seed + 7 * j)
                        for j, (cfg, d) in enumerate(densities.items())}

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        img = self.imgs[i]
        return {'imgs': (img - self.mean) / self.std}, {'imgs': img.copy()}, \
            {'items': str(i), **self.META[self.name], 'errors': ''}

    def _frames(self, scenes, name: str, n: int) -> None:
        """`n` frames of `scenes` at the predictor's input shape for `name`."""
        from slowtv_monodepth_tpu_torch.core import BenchmarkPredictor
        from slowtv_monodepth_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
        from slowtv_monodepth_tpu_torch.utils.resize import resize
        self.name, self.n = name, n
        self.h, self.w = BenchmarkPredictor.get_img_shape(name)
        base = [np.stack([resize(sc[..., c], (self.h, self.w)) for c in range(3)], -1)
                for sc in scenes]
        self.imgs = [np.roll(base[i % len(base)], 37 * i, axis=1) for i in range(n)]
        self.mean, self.std = IMAGENET_MEAN, IMAGENET_STD

    @staticmethod
    def collate_fn(items):
        from slowtv_monodepth_tpu_torch.data import collate_items
        return collate_items(items)


class MapFreeStandIn(EvalStandIn):
    """In-memory stand-in for `MapFreeRelocDataset` as `mapfree_preds` builds it
    (datum 'image depth', portrait 512x384), one batch of frames: in y the DPT depth
    target of each frame at the dataset's SHAPE 720x540, once `fit_targets` has
    made them; in m the frame's mode, scene, seq and stem (the PNG's path under
    `paths.DATA_PATHS['mapfree']`). `tests/test_torch_mapfree.py` holds the layout
    to the real dataset's."""

    SHAPE = (720, 540)

    def __init__(self, scenes):
        from slowtv_monodepth_tpu_torch.mapfree_preds import BATCH_SIZE
        self._frames(scenes, 'mapfree', BATCH_SIZE)
        self.depths = None

    def fit_targets(self, disp: np.ndarray) -> None:
        """The targets from the maps `disp` predicted for these frames: each upsampled
        to SHAPE and mapped affinely in disparity onto 1-80 m, so that the lsqr
        alignment of `mapfree_preds` recovers them as far as a random net's nearly
        flat maps let it (its 2 x 2 system is ill-conditioned)."""
        from slowtv_monodepth_tpu_torch.utils.resize import resize
        self.depths = []
        for d in disp:
            up = resize(d, self.SHAPE, 'bilinear').astype(np.float64)
            u = (up - up.min()) / (up.max() - up.min())
            self.depths.append((1 / (1 / 80 + u * (1 - 1 / 80))).astype(np.float32))

    def __getitem__(self, i: int):
        img = self.imgs[i]
        y = {'imgs': img.copy()}
        if self.depths is not None:  # predicting the maps for `fit_targets` needs none
            y['depth'] = self.depths[i][..., None]
        return {'imgs': (img - self.mean) / self.std}, y, \
            {'items': str(i), 'mode': 'val', 'scene': f's{i // 8:05}', 'seq': 'seq0',
             'stem': f'frame_{i % 8:05}', 'errors': ''}


def _sigmoid_err(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| of two exported maps in the units of the network's sigmoid:
    `export_preds` maps it onto [1 / max_depth, 1 / min_depth]."""
    span = 1 / KBR_TRAINER_CFG['min_depth'] - 1 / KBR_TRAINER_CFG['max_depth']
    return float(np.abs(a.astype(np.float64) - b).max() / span)


def phase_eval(sd, scenes, smi: str) -> None:
    """The evaluation chain as `slowtv-export-preds-torch` and `slowtv-eval-depth-torch`
    run it, on in-memory stand-ins of SYNS-Patches, KITTI and MannequinChallenge
    (`EvalStandIn`, `EVAL_ITEMS` each): a seeded full-width KBR checkpoint and its
    `finished` marker; `export_preds.compute_preds` in batches of 12 (and a partial
    one), every map against the plain path; the fused blocks through a second
    checkpoint; `MonoDepthEvaluator` with each cfg's args in a Pool of
    `EVAL_NPROC` and in process, a perfect prediction, and the seconds per item of
    each metric family at the targets' full size. `smi` is the card's name and power
    limit, printed beside the times."""
    from slowtv_monodepth_tpu_torch.core import save_checkpoint
    from slowtv_monodepth_tpu_torch.eval import MonoDepthEvaluator
    from slowtv_monodepth_tpu_torch.eval_depth import evaluate as evaluate_depth
    from slowtv_monodepth_tpu_torch.export_preds import compute_preds, load_predictor, predict
    from slowtv_monodepth_tpu_torch.models import DepthNet
    t_phase = time.perf_counter()
    print(f'eval: on {smi}')
    n_blocks = sum(CONVNEXT_B_BLOCKS)
    sets = {name: EvalStandIn(scenes, name, seed=RUN_SEED + i)
            for i, name in enumerate(EVAL_A8A_SETS)}

    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {}
        for tag, depth_cfg in (('kernel', KBR_DEPTH_CFG),
                               ('fused', {**KBR_DEPTH_CFG, 'fused_blocks': True})):
            ckpts[tag] = Path(tmp) / tag / 'models' / 'last.ckpt'
            save_checkpoint(ckpts[tag], {'depth': sd}, {'net': {'depth': depth_cfg},
                                                        'trainer': KBR_TRAINER_CFG})
        try:
            compute_preds(None, str(ckpts['kernel']), ds=sets['syns_patches'])
            fail('eval: export_preds accepted a run without its `finished` marker')
        except SystemExit:
            print('eval: export_preds refused the unfinished run (no `finished` marker)')
        for path in ckpts.values():
            (path.parent / 'finished').touch()

        def export(tag: str, ds) -> tuple[np.ndarray, dict, float]:
            _reset_counts()
            t0 = time.perf_counter()
            preds = compute_preds(None, str(ckpts[tag]), ds=ds)
            torch.cuda.synchronize()
            return preds, _read_counts(), time.perf_counter() - t0

        predictor, net = load_predictor(str(ckpts['kernel']))
        plain = DepthNet(**KBR_DEPTH_CFG, kernels=False)
        plain.load_state_dict(net.state_dict())
        plain = plain.cuda().eval()
        preds, plains = {}, {}
        for name, ds in sets.items():
            preds[name], counts, wall = export('kernel', ds)
            batches = -(-len(ds) // EVAL_BATCH)
            want = {**dict.fromkeys(counts, 0), 'dwconv': n_blocks * batches,
                    'decoder_stage': 2 * batches}
            if counts != want:
                fail(f'eval {name}: launches {counts}, expected {want}')
            plains[name] = predict(predictor, plain, ds, num_workers=0)
            err = _sigmoid_err(preds[name], plains[name])
            t0 = time.perf_counter()
            predict(predictor, net, ds)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            x = np.stack([ds[i][0]['imgs'] for i in range(min(EVAL_BATCH, len(ds)))])
            x = torch.from_numpy(x).cuda().permute(0, 3, 1, 2).contiguous()
            with torch.no_grad():
                t = cuda_ms(lambda: net(x)['disp'][0], iters=3, warmup=1)
                tp = cuda_ms(lambda: plain(x)['disp'][0], iters=3, warmup=1)
            ok = (preds[name].shape == (len(ds), ds.h, ds.w) and np.isfinite(preds[name]).all()
                  and preds[name].std() > 1e-4)
            print(f'eval export {name}: {len(ds)} items {ds.h}x{ds.w} in {batches} batches of '
                  f'{EVAL_BATCH}, launches {counts}; first export {wall:.2f} s (checkpoint load '
                  f'included), warm {len(ds) / warm:.1f} images/s; device ms per batch of '
                  f'{EVAL_BATCH} (eager): kernel {t.ms:.2f} ({t.eager_ms:.2f}), plain {tp.ms:.2f} '
                  f'({tp.eager_ms:.2f}); max|kernel - plain| {err:.2e} of the sigmoid '
                  f'(tol {GOLDEN_ATOL:.0e}); maps {"ok" if ok else "BAD"}')
            if not ok or not err <= GOLDEN_ATOL:
                fail(f'eval {name}: maps {preds[name].shape}, off the plain path by {err}')
            del x

        # A partial last batch (12 + 5) at 192x640, against the plain path.
        part = EvalStandIn(scenes, 'syns_patches', n=EVAL_PARTIAL, seed=RUN_SEED)
        got, counts, _ = export('kernel', part)
        err = _sigmoid_err(got, predict(predictor, plain, part, num_workers=0))
        print(f'eval export syns_patches, {EVAL_PARTIAL} items (batches of 12 and 5): launches '
              f'{counts}; max|kernel - plain| {err:.2e} (tol {GOLDEN_ATOL:.0e})')
        if (counts['dwconv'], counts['decoder_stage']) != (2 * n_blocks, 4) or not err <= GOLDEN_ATOL:
            fail(f'eval: the partial batch: launches {counts}, off the plain path by {err}')

        # The fused blocks (kernel 9) through a checkpoint whose cfg turns them on.
        fused, counts, _ = export('fused', sets['syns_patches'])
        batches = -(-len(sets['syns_patches']) // EVAL_BATCH)
        want = {**dict.fromkeys(counts, 0), 'convnext_block': n_blocks * batches,
                'decoder_stage': 2 * batches}
        err = _sigmoid_err(fused, preds['syns_patches'])
        print(f'eval export syns_patches, fused blocks: launches {counts}; max|fused - unfused| '
              f'{err:.2e} (tol {GOLDEN_ATOL:.0e})')
        if counts != want or not err <= GOLDEN_ATOL:
            fail(f'eval: fused blocks: launches {counts} (expected {want}), off by {err}')
    del net, plain
    torch.cuda.empty_cache()

    # The evaluator, in the process that initialised CUDA: a Pool, then in process.
    # (`run` prints each mean as a LaTeX table: kept out of this log.)
    def evaluate(*args, **kw):
        with contextlib.redirect_stdout(io.StringIO()):
            return evaluate_depth(*args, **kw)

    for name, ds in sets.items():
        for cfg, data in ds.targets.items():
            args = EVAL_ARGS[cfg]
            t0 = time.perf_counter()
            mean, items = evaluate(preds[name], data, args, EVAL_ALIGN, nproc=EVAL_NPROC)
            wall = time.perf_counter() - t0
            _, serial = evaluate(preds[name], data, args, EVAL_ALIGN, nproc=0,
                                 max_items=EVAL_SERIAL_ITEMS)
            if serial != items[:EVAL_SERIAL_ITEMS] or len(items) != len(ds):
                fail(f'eval {cfg}: nproc=0 gave {serial}, nproc={EVAL_NPROC} {items[:2]}')
            if not all(np.isfinite(v) for v in mean.values()):
                fail(f'eval {cfg}: metrics {mean}')
            _, plain_items = evaluate(plains[name], data, args, EVAL_ALIGN, nproc=EVAL_NPROC,
                                      max_items=EVAL_PLAIN_ITEMS)
            cont, steps = (0.0, ''), (0.0, '')
            for a, b in zip(items, plain_items):
                for k, v in b.items():
                    if not isinstance(v, float):
                        continue
                    if any(t in k for t in EVAL_THRESHOLDED):
                        steps = max(steps, (abs(a[k] - v), k))
                    else:
                        cont = max(cont, (abs(a[k] - v) / max(abs(v), 1e-12), k))
            # A perfect prediction: the target's own disparity at its shape (in double),
            # median-aligned (exact here; lsqr's solve is good to ~1e-7 of the scale).
            depth = data['depth'][0].astype(np.float32)
            disp = np.where(depth > 0, 1 / np.maximum(depth.astype(np.float64), 1e-6), 0)
            best, _ = evaluate(disp[None], {'depth': depth[None], 'K': data['K'][:1]},
                               {**args, 'metrics': ['eigen', 'pointcloud']}, 'median', nproc=0)
            ev = MonoDepthEvaluator(align_mode=EVAL_ALIGN, **{k: v for k, v in args.items()
                                                              if k != 'metrics'})
            secs = {}
            for fam in args['metrics']:
                t1 = time.perf_counter()
                ev(preds[name][0], depth, [fam], data['K'][0],
                   data['edge'][0] if fam == 'ibims' else None)
                secs[fam] = time.perf_counter() - t1
            ragged = 'object array, ' if data['depth'].dtype == object else ''
            shown = [k for k in ('AbsRel', 'RMSE', 'F-Score (10)', 'Chamfer') if k in mean]
            print(f'eval {cfg} ({name} stand-in, targets {depth.shape} ({ragged}'
                  f'{100 * (depth > 0).mean():.0f}% valid), align {EVAL_ALIGN}): '
                  f'{len(items)} items, nproc={EVAL_NPROC} {wall:.1f} s; nproc=0 on the first {EVAL_SERIAL_ITEMS} '
                  f'items equal; ' + ', '.join(f'{k} {mean[k]:.4g}' for k in shown)
                  + f'; kernel vs plain predictions over {EVAL_PLAIN_ITEMS} items: continuous '
                  f'metrics {cont[0]:.2e} relative ({cont[1]}), thresholded {steps[0]:.4f} '
                  f'points ({steps[1]}); perfect prediction (median) AbsRel {best["AbsRel"]:.2e}, '
                  f'F-Score (10) {best["F-Score (10)"]:.4f}; '
                  f'evaluator s/item at the target\'s full size: '
                  + ', '.join(f'{k} {v:.3f}' for k, v in secs.items()))
            if not best['AbsRel'] < 1e-6 or not abs(best['F-Score (10)'] - 100) < 1e-3:
                fail(f'eval {cfg}: a perfect prediction scored {best}')
    print(f'eval: phase wall {time.perf_counter() - t_phase:.1f} s')



def read_png16(path: Path) -> np.ndarray:
    """A 16-bit greyscale PNG as `utils/png.py` writes it -> (h, w) uint16, decoded
    here in numpy (no PIL or cv2 on the card's machine): the signature, every chunk's
    CRC, IHDR (bit depth 16, colour type 0, no interlace), the IDAT stream inflated,
    each row's filter byte (0: none)."""
    import struct
    import zlib
    data = Path(path).read_bytes()
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        fail(f'mapfree: {path} is not a PNG')
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack('>I', data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(tag + body):
            fail(f'mapfree: {path}: bad CRC of {tag}')
        chunks.setdefault(tag, []).append(body)
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = struct.unpack('>IIBBBBB', chunks[b'IHDR'][0])
    if (depth, colour, interlace) != (16, 0, 0) or b'IEND' not in chunks:
        fail(f'mapfree: {path}: IHDR {w}x{h} depth {depth} colour {colour}')
    rows = np.frombuffer(zlib.decompress(b''.join(chunks[b'IDAT'])), np.uint8).reshape(h, -1)
    if rows.shape[1] != 1 + 2 * w or rows[:, 0].any():
        fail(f'mapfree: {path}: rows {rows.shape}, filters {np.unique(rows[:, 0])}')
    return rows[:, 1:].copy().view('>u2').astype(np.uint16)


def phase_eval_zero_shot(sd, scenes, smi: str) -> None:
    """Zero-shot evaluation (phase 16) as `slowtv-export-preds-torch`,
    `slowtv-eval-depth-torch` and `slowtv-mapfree-preds-torch` run it, on in-memory
    stand-ins of DDAD, DIODE, NYUD-v2, Sintel and TUM-RGBD (`EVAL_ITEMS` each: one
    batch of `export_preds`) and of MapFreeReloc (one batch of `mapfree_preds`): the
    input shapes new to kernels 1, 3 and 9 (416x640, 480x640, 288x640, 512x384) at the
    batches the entry points feed them, every map against the plain path,
    the evaluator with each cfg's args and a perfect prediction, and the PNGs that
    `mapfree_preds` writes read back. `smi` is the card's name and power limit,
    printed beside the times."""
    from slowtv_monodepth_tpu_torch import mapfree_preds, paths
    from slowtv_monodepth_tpu_torch.core import save_checkpoint
    from slowtv_monodepth_tpu_torch.eval import MonoDepthEvaluator
    from slowtv_monodepth_tpu_torch.eval_depth import evaluate as evaluate_depth
    from slowtv_monodepth_tpu_torch.export_preds import compute_preds, load_predictor, predict
    from slowtv_monodepth_tpu_torch.models import DepthNet
    t_phase = time.perf_counter()
    print(f'eval zero-shot: on {smi}')
    n_blocks = sum(CONVNEXT_B_BLOCKS)
    sets = {name: EvalStandIn(scenes, name, seed=RUN_SEED + 10 + i)
            for i, name in enumerate(ZERO_SHOT_SETS)}

    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {}
        for tag, depth_cfg in (('kernel', KBR_DEPTH_CFG),
                               ('fused', {**KBR_DEPTH_CFG, 'fused_blocks': True})):
            ckpts[tag] = Path(tmp) / tag / 'models' / 'last.ckpt'
            save_checkpoint(ckpts[tag], {'depth': sd}, {'net': {'depth': depth_cfg},
                                                        'trainer': KBR_TRAINER_CFG})
            (ckpts[tag].parent / 'finished').touch()

        def export(tag: str, ds) -> tuple[np.ndarray, dict]:
            _reset_counts()
            preds = compute_preds(None, str(ckpts[tag]), ds=ds)
            torch.cuda.synchronize()
            return preds, _read_counts()

        def device_ms(ds, b: int) -> tuple[Timing, Timing]:
            x = np.stack([ds[i][0]['imgs'] for i in range(b)])
            x = torch.from_numpy(x).cuda().permute(0, 3, 1, 2).contiguous()
            with torch.no_grad():
                return (cuda_ms(lambda: net(x)['disp'][0], iters=3, warmup=1),
                        cuda_ms(lambda: plain(x)['disp'][0], iters=3, warmup=1))

        predictor, net = load_predictor(str(ckpts['kernel']))
        plain = DepthNet(**KBR_DEPTH_CFG, kernels=False)
        plain.load_state_dict(net.state_dict())
        plain = plain.cuda().eval()
        preds = {}
        for name, ds in sets.items():
            preds[name], counts = export('kernel', ds)
            want = {**dict.fromkeys(counts, 0), 'dwconv': n_blocks, 'decoder_stage': 2}
            if counts != want:
                fail(f'eval zero-shot {name}: launches {counts}, expected {want}')
            err = _sigmoid_err(preds[name], predict(predictor, plain, ds, num_workers=0))
            t0 = time.perf_counter()
            predict(predictor, net, ds)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            t, tp = device_ms(ds, len(ds))
            ok = (preds[name].shape == (len(ds), ds.h, ds.w) and np.isfinite(preds[name]).all()
                  and preds[name].std() > 1e-4)
            print(f'eval zero-shot export {name}: {len(ds)} items {ds.h}x{ds.w} (stage-4 map '
                  f'{ds.h // 32}x{ds.w // 32}) in 1 batch, launches {counts}; warm '
                  f'{len(ds) / warm:.1f} images/s; device ms per batch of {len(ds)} (eager): '
                  f'kernel {t.ms:.2f} ({t.eager_ms:.2f}), plain {tp.ms:.2f} ({tp.eager_ms:.2f}); '
                  f'max|kernel - plain| {err:.2e} of the sigmoid (tol {GOLDEN_ATOL:.0e}); maps '
                  f'{"ok" if ok else "BAD"}')
            if not ok or not err <= GOLDEN_ATOL:
                fail(f'eval zero-shot {name}: maps {preds[name].shape}, off the plain path by '
                     f'{err}')

        # The fused blocks (kernel 9) at DDAD's 416x640: 13-row stage-4 maps.
        fused, counts = export('fused', sets['ddad'])
        want = {**dict.fromkeys(counts, 0), 'convnext_block': n_blocks, 'decoder_stage': 2}
        err = _sigmoid_err(fused, preds['ddad'])
        print(f'eval zero-shot export ddad, fused blocks: launches {counts}; max|fused - '
              f'unfused| {err:.2e} (tol {GOLDEN_ATOL:.0e})')
        if counts != want or not err <= GOLDEN_ATOL:
            fail(f'eval zero-shot: fused blocks at 416x640: launches {counts} (expected '
                 f'{want}), off by {err}')

        # MapFree: `mapfree_preds` writes its PNGs next to each frame of the data root,
        # aligned to DPT targets made from the kernel path's own maps.
        mf = MapFreeStandIn(scenes)
        disp = predict(predictor, net, mf, batch_size=len(mf), num_workers=0)
        mf_err = _sigmoid_err(disp, predict(predictor, plain, mf, batch_size=len(mf),
                                            num_workers=0))
        mf.fit_targets(disp)
        root = Path(tmp) / 'mapfree'
        files = []
        for i in range(len(mf)):
            m = mf[i][2]
            (root / m['mode'] / m['scene'] / m['seq']).mkdir(parents=True, exist_ok=True)
            files.append(root / m['mode'] / m['scene'] / m['seq'] / f'{m["stem"]}.kbr.png')
        paths.DATA_PATHS['mapfree'] = root
        try:
            _reset_counts()
            t0 = time.perf_counter()
            n = mapfree_preds.compute_preds('kbr', None, str(ckpts['kernel']), ds=mf)
            wall = time.perf_counter() - t0
            counts = _read_counts()
        finally:
            paths.DATA_PATHS.pop('mapfree', None)
        want = {**dict.fromkeys(counts, 0), 'dwconv': n_blocks, 'decoder_stage': 2}
        if counts != want or n != len(mf) or not mf_err <= GOLDEN_ATOL:
            fail(f'mapfree: launches {counts} (expected {want}), {n} files written, maps off '
                 f'the plain path by {mf_err}')
        # The same millimetres as the host path on the same maps, and the targets'.
        worst, rel, lo, hi = 0, [], np.inf, 0.0
        for i, f in enumerate(files):
            png = read_png16(f)
            target = mf.depths[i]
            depth = mapfree_preds.align(mapfree_preds.upsample(disp[i], target), target)
            want_mm = (depth * 1000).astype(np.uint16)
            if png.shape != target.shape:
                fail(f'mapfree: {f.name} is {png.shape}, expected {target.shape}')
            worst = max(worst, int(np.abs(png.astype(np.int64) - want_mm).max()))
            rel.append(float(np.median(np.abs(png / 1000 - target) / target)))
            lo, hi = min(lo, png.min() / 1000), max(hi, png.max() / 1000)
        t, tp = device_ms(mf, len(mf))
        print(f'eval zero-shot mapfree: {len(mf)} frames {mf.h}x{mf.w} (stage-4 map '
              f'{mf.h // 32}x{mf.w // 32}) in 1 batch, launches {counts}; max|kernel - plain| '
              f'{mf_err:.2e} of the sigmoid (tol {GOLDEN_ATOL:.0e}); '
              f'{n} PNGs {target.shape[0]}x{target.shape[1]} uint16 mm read back (CRCs, IHDR), '
              f'depths {lo:.3f}-{hi:.3f} m, max |PNG - host path| {worst} mm (tol 1), '
              f'median |PNG - target| / target {np.median(rel):.2e}; '
              f'{wall:.2f} s (checkpoint load and writes included), {len(mf) / wall:.1f} '
              f'images/s; device ms per batch of {len(mf)} (eager): kernel {t.ms:.2f} '
              f'({t.eager_ms:.2f}), plain {tp.ms:.2f} ({tp.eager_ms:.2f})')
        if worst > 1 or not lo > 0:
            fail(f'mapfree: PNGs off the host path by {worst} mm, depths {lo}-{hi} m')
    del net, plain
    torch.cuda.empty_cache()

    def evaluate(*args, **kw):
        with contextlib.redirect_stdout(io.StringIO()):
            return evaluate_depth(*args, **kw)

    for name, ds in sets.items():
        for cfg, data in ds.targets.items():
            args = EVAL_ARGS[cfg]
            t0 = time.perf_counter()
            mean, items = evaluate(preds[name], data, args, EVAL_ALIGN, nproc=EVAL_NPROC)
            wall = time.perf_counter() - t0
            if len(items) != len(ds) or not all(np.isfinite(v) for v in mean.values()):
                fail(f'eval zero-shot {cfg}: {len(items)} items, metrics {mean}')
            # A perfect prediction, median-aligned: AbsRel 0 unless a crop or range is wrong.
            depth = data['depth'][0].astype(np.float32)
            disp = np.where(depth > 0, 1 / np.maximum(depth.astype(np.float64), 1e-6), 0)
            fams = ['eigen'] + (['pointcloud'] if 'K' in data else [])
            best, _ = evaluate(disp[None], {'depth': depth[None], **(
                {'K': data['K'][:1]} if 'K' in data else {})}, {**args, 'metrics': fams},
                'median', nproc=0)
            ev = MonoDepthEvaluator(align_mode=EVAL_ALIGN, **{k: v for k, v in args.items()
                                                              if k != 'metrics'})
            # In process, family by family on the first item: timed, and together equal
            # to the Pool's metrics of it.
            secs, serial = {}, {}
            for fam in args['metrics']:
                t1 = time.perf_counter()
                serial |= ev(preds[name][0], depth, [fam], data['K'][0] if 'K' in data else None)
                secs[fam] = time.perf_counter() - t1
            if serial != items[0]:
                fail(f'eval zero-shot {cfg}: in process {serial}, Pool {items[0]}')
            shown = [k for k in ('AbsRel', 'RMSE', 'F-Score (10)') if k in mean]
            print(f'eval zero-shot {cfg} ({name} stand-in, targets {depth.shape} '
                  f'({100 * (depth > 0).mean():.0f}% valid), align {EVAL_ALIGN}): {len(items)} '
                  f'items, nproc={EVAL_NPROC} {wall:.1f} s, the first item equal in process; '
                  + ', '.join(f'{k} {mean[k]:.4g}' for k in shown)
                  + f'; perfect prediction (median) AbsRel {best["AbsRel"]:.2e}'
                  + (f', F-Score (10) {best["F-Score (10)"]:.4f}' if 'K' in data else '')
                  + '; evaluator s/item at the target\'s full size: '
                  + ', '.join(f'{k} {v:.3f}' for k, v in secs.items()))
            if not best['AbsRel'] < 1e-6 or ('K' in data
                                              and not abs(best['F-Score (10)'] - 100) < 1e-3):
                fail(f'eval zero-shot {cfg}: a perfect prediction scored {best}')
    print(f'eval zero-shot: phase wall {time.perf_counter() - t_phase:.1f} s')

@functools.lru_cache(maxsize=None)
def _seeded_weights(key: str, net_cfg: str) -> dict:
    """`models.seeded_state_dict` of the net `key` of a cfg (its section as JSON), drawn
    once a process: the pose net is the same in most families (BatchNorm's running
    statistics drawn too: a positive variance, counters at 0)."""
    from slowtv_monodepth_tpu_torch import parsers
    from slowtv_monodepth_tpu_torch.models import seeded_state_dict
    with torch.device('meta'):
        net = parsers.get_net({key: json.loads(net_cfg)})[key]
    return {k: torch.from_numpy(v) for k, v in seeded_state_dict(net, 0).items()}


def family_cfg(name: str) -> dict:
    """`BENCH_DEFAULT_CFG` merged with the family's file."""
    from slowtv_monodepth_tpu_torch.config import merge_dicts
    return merge_dicts(BENCH_DEFAULT_CFG, FAMILY_FILE_CFGS[name])


def _family_pass(trainer, x, y, supp, noise) -> dict:
    """One forward + backward of a family's loss (no update) -> loss, its terms, every
    parameter's gradient, every BatchNorm's running statistics after it, the gates' bits
    and the launches it made."""
    trainer.nets.train()
    trainer.nets.zero_grad(set_to_none=True)
    _reset_counts()
    loss, (ld, _) = trainer.loss_fn(x, y, supp, noise=noise)
    loss.backward()
    torch.cuda.synchronize()
    return {'counts': _read_counts(), 'loss': loss.item(),
            'terms': {k: v.item() for k, v in ld.items() if k.startswith('loss_')},
            'bits': {k: ld[k].detach().clone() for k in ('automask', 'automask_hints') if k in ld},
            'grads': {f'{n}.{k}': p.grad.detach().clone() for n, net in trainer.nets.items()
                      for k, p in net.named_parameters() if p.grad is not None},
            'stats': {f'{n}.{k}': b.detach().clone() for n, net in trainer.nets.items()
                      for k, b in net.named_buffers() if 'running' in k},
            'counters': {int(b) for net in trainer.nets.values()
                         for k, b in net.named_buffers() if k.endswith('num_batches_tracked')},
            'n_params': sum(1 for net in trainer.nets.values() for _ in net.parameters())}


def _family_compare(got: dict, want: dict) -> tuple[list, list]:
    """The kernel path (`got`) against the plain path (`want`) -> faults and the
    text for the log."""
    faults, flips, notes = [], 0, []
    for k, bits in got['bits'].items():
        n = int((bits != want['bits'][k]).sum())
        flips += n
        notes.append(f'{k} {n} of {bits.numel()} bits differ ({n / bits.numel():.1e})')
        if n > FAMILY_GATE_SHARE * bits.numel():
            faults.append(f'{k}: {n} of {bits.numel()} bits differ')
    if got['n_params'] != len(got['grads']) or got['n_params'] != len(want['grads']):
        faults.append(f'{len(got["grads"])} / {len(want["grads"])} gradients of '
                      f'{got["n_params"]} parameters')
    for k in ['loss'] + sorted(want['terms']):
        g, w = (got['loss'], want['loss']) if k == 'loss' else (got['terms'][k], want['terms'][k])
        rtol = FAMILY_GATE_RTOL if flips and k in ('loss', 'loss_depth_regr') else 1e-5
        if not abs(g - w) <= rtol * abs(w):
            faults.append(f'{k}: {g:.7g} vs plain {w:.7g} (rtol {rtol:.0e})')
    worst = 0.0
    for k, w in want['grads'].items():
        g = got['grads'][k]
        if not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0:
            faults.append(f'{k}: gradient non-finite or zero')
            continue
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, rel) if not (flips and k.startswith('depth.')) else worst
        bound = FAMILY_GATE_POSE_RTOL if flips else 1e-3
        if not (flips and k.startswith('depth.')) and rel > bound:
            faults.append(f'{k}: gradient off by {rel:.2e} of its largest (bound {bound:.0e})')
    if flips:
        keys = [k for k in want['grads'] if k.startswith('depth.')]
        num = torch.sqrt(sum(((got['grads'][k] - want['grads'][k]).double() ** 2).sum()
                             for k in keys))
        den = torch.sqrt(sum((want['grads'][k].double() ** 2).sum() for k in keys))
        l2 = float(num / den)
        notes.append(f'depth net gradient {l2:.2e} relative L2 (bound {FAMILY_GATE_DEPTH_L2:.0e})')
        if l2 > FAMILY_GATE_DEPTH_L2:
            faults.append(f'depth net gradient {l2:.2e} relative L2')
    notes.append(f'worst gradient {worst:.2e} of its tensor\'s largest'
                 + (' (pose net; gate flips)' if flips else ''))
    if got['counters'] - {1} or sorted(got['stats']) != sorted(want['stats']):
        faults.append(f'BatchNorm counters {got["counters"]} after one pass')
    worst = 0.0
    for k, w in want['stats'].items():  # the batch statistics of the same activations
        rel = float((got['stats'][k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, rel)
        if not rel <= BN_STATS_RTOL:
            faults.append(f'{k}: off by {rel:.2e} of its largest (bound {BN_STATS_RTOL:.0e})')
    if want['stats']:
        notes.append(f'{len(want["stats"])} BatchNorm running statistics, worst {worst:.2e} '
                     'of its largest')
    return faults, notes


def _step_inputs(cfg: dict, loader: SceneLoader, seed: int) -> tuple:
    """A batch of `FAMILY_B` frames for `cfg` on the card (`family_batch`: its supports,
    hints where it regresses them) and the automask noise where it has an automask ->
    (x, y, supports, noise or None)."""
    supp = tuple(cfg['dataset']['kitti_lmdb']['supp_idxs'])
    rs = np.random.RandomState(seed)
    x, y = family_batch(loader, rs.randint(0, len(loader.base), FAMILY_B), supp,
                        'depth_regr' in cfg['loss'], rs)
    x, y = ({k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in d.items()}
            for d in (x, y))
    n_sc = len(cfg['net']['depth']['out_scales'])
    noise = (torch.from_numpy(rs.standard_normal((n_sc * FAMILY_B,) + FAMILY_SHAPE + (1,))
                              .astype(np.float32)).cuda()
             if cfg['loss']['img_recon'].get('use_automask') else None)
    return x, y, supp, noise


def _both_paths(cfg: dict, x, y, supp, noise, tag: str,
                expect: dict) -> tuple[dict, dict, dict, list]:
    """One forward + backward of `cfg`'s loss on the kernel path and on the plain path from
    the same seeded weights and batch; the kernel path's launches held to `expect` and its
    results to the plain path's (`_family_compare`) -> (passes, device times, peak GiB,
    notes), keyed by `kernels`."""
    from slowtv_monodepth_tpu_torch.core.trainer import MonoDepthTrainer
    weights = {k: _seeded_weights(k, json.dumps(net_cfg, sort_keys=True))
               for k, net_cfg in cfg['net'].items() if net_cfg}
    passes, times, peaks = {}, {}, {}
    for kernels in (True, False):
        # Shapes only, then the seeded weights on the card: no initial draw (seconds a net
        # on the host; on the card, the CUDA generator after a failed capture refuses it).
        with torch.device('meta'):
            trainer = MonoDepthTrainer(cfg, kernels=kernels)
        trainer.nets.to_empty(device='cuda')
        for k, sd in weights.items():
            trainer.nets[k].load_state_dict(sd)
        torch.cuda.reset_peak_memory_stats()
        passes[kernels] = _family_pass(trainer, x, y, supp, noise)

        def fwd_bwd(trainer=trainer):
            trainer.nets.zero_grad(set_to_none=True)
            trainer.loss_fn(x, y, supp, noise=noise)[0].backward()
        times[kernels] = cuda_ms(fwd_bwd, iters=2, warmup=1)
        peaks[kernels] = torch.cuda.max_memory_allocated() / 2 ** 30
        del trainer, fwd_bwd
        gc.collect()
        torch.cuda.empty_cache()
    got = {k: passes[True]['counts'][k] for k in expect}
    if got != expect or any(passes[False]['counts'].values()):
        fail(f'{tag}: launches per micro-step {got}, expected {expect}; '
             f'plain path {passes[False]["counts"]}')
    faults, notes = _family_compare(passes[True], passes[False])
    if faults:
        fail(f'{tag}: kernel path against the plain path: ' + '; '.join(faults))
    return passes, times, peaks, notes


def phase_families(scenes, smi: str) -> None:
    """The recipe families beside KBR at published widths (ConvNeXt-B, 4 scales, B=8,
    192x640): one micro-step (forward + backward) of DVSO as it stands, Depth-Hints-MS,
    SfM-Learner and Klodt on the kernel path and on the plain path from the same seeded
    weights and batch, held to each other; launches per kernel; device ms per
    micro-step. Then DVSO through `MonoDepthLoop`: 2 epochs of 2 batches over
    `StereoHintLoader`, `last.ckpt`, one validation batch."""
    from slowtv_monodepth_tpu_torch.core import load_checkpoint
    t0 = time.perf_counter()
    print(f'families: pose encoder {BENCH_DEFAULT_CFG["net"]["pose"]["enc_name"]} as published '
          'in every family that keeps a pose net')
    loader = SceneLoader(scenes, 1, FAMILY_SHAPE, batch=FAMILY_B)
    for fam_i, name in enumerate(FAMILY_FILE_CFGS):
        cfg = family_cfg(name)
        x, y, supp, noise = _step_inputs(cfg, loader, RUN_SEED + fam_i)
        passes, times, _, notes = _both_paths(cfg, x, y, supp, noise, f'families {name}',
                                              FAMILY_LAUNCHES[name])
        got_counts = {k: passes[True]['counts'][k] for k in FAMILY_LAUNCHES[name]}
        k_ms, p_ms = times[True], times[False]
        nets = sorted(v['enc_name'] for v in cfg['net'].values() if v)
        print(f'families {name} (supports {list(supp)}, nets {nets}): '
              f'loss {passes[True]["loss"]:.6f} (plain {passes[False]["loss"]:.6f}); '
              + '; '.join(notes) + f'; every one of {passes[True]["n_params"]} parameters with a '
              f'finite non-zero gradient; launches per micro-step {got_counts}; device ms per '
              f'micro-step (forward + backward, no update; eager in brackets, timed by '
              f'{k_ms.how}/{p_ms.how}): kernel {k_ms.ms:.2f} ({k_ms.eager_ms:.2f}), plain '
              f'{p_ms.ms:.2f} ({p_ms.eager_ms:.2f}) on {smi}')
        del passes
        torch.cuda.empty_cache()

    # DVSO through the loop as `slowtv-train-torch` runs it.
    cfg = family_cfg('dvso')
    cfg = {**cfg, 'seed': RUN_SEED, 'trainer': {
        **cfg['trainer'], 'max_epochs': FAMILY_RUN_EPOCHS, 'log_every_n_steps': 1,
        'limit_val_batches': 1, 'matmul': 'highest'}}
    n = FAMILY_RUN_EPOCHS * FAMILY_RUN_BATCHES
    with tempfile.TemporaryDirectory() as tmp:
        loop, st = _run_loop(cfg, Path(tmp) / 'run', scenes, val=True, tag='families dvso',
                             loaders=(StereoHintLoader(scenes, FAMILY_RUN_BATCHES, True, RUN_SEED),
                                      StereoHintLoader(scenes, 1, False, RUN_SEED + 1)))
        sd, ckpt_cfg = load_checkpoint(Path(tmp) / 'run' / 'last.ckpt')
    per_step, val_step = FAMILY_LAUNCHES['dvso'], FAMILY_VAL_LAUNCHES
    expect = {k: n * v + FAMILY_RUN_EPOCHS * val_step.get(k, 0) for k, v in per_step.items()}
    if st['counts'] != expect:
        fail(f'families dvso run: launches {st["counts"]}, expected {expect}')
    outconv = sd.get('nets.depth.decoders.disp.decoder.10.weight')
    if loop.global_step != n or outconv is None or outconv.shape[0] != 3 \
            or not ckpt_cfg['net']['depth']['use_virtual_stereo'] or 'nets.pose' in ' '.join(sd):
        fail(f'families dvso run: {loop.global_step} micro-steps, last.ckpt {len(sd)} tensors')
    val = {k: st['val'].get(k) for k in ('loss', 'loss_stereo_const', 'loss_depth_regr', 'AbsRel')}
    if not all(v is not None and np.isfinite(v) for v in val.values()):
        fail(f'families dvso run: validation scalars {val}')
    print(f'families dvso run: {FAMILY_RUN_EPOCHS} epochs x {FAMILY_RUN_BATCHES} batches of '
          f'{FAMILY_B} at {FAMILY_SHAPE[0]}x{FAMILY_SHAPE[1]}, supports [0], no pose net: '
          f'launches {st["counts"]} (per train micro-step {per_step}, per validation step '
          f'{val_step}); last.ckpt {len(sd)} tensors (the disparity outconv 3 channels); '
          'validation ' + ', '.join(f'{k} {v:.4g}' for k, v in val.items()))
    torch.backends.cudnn.benchmark = False
    print(f'families: phase wall {time.perf_counter() - t0:.1f} s')


def resnet_cfg(name: str) -> dict:
    """`BENCH_DEFAULT_CFG` merged with the files of `RESNET_FILE_CFGS[name]`."""
    from slowtv_monodepth_tpu_torch.config import merge_dicts
    cfg = BENCH_DEFAULT_CFG
    for part in RESNET_FILE_CFGS[name]:
        cfg = merge_dicts(cfg, part)
    return cfg


def phase_resnet(scenes, smi: str) -> None:
    """The ResNet and ResNeXt nets at published widths (B=8, 192x640, 4 scales): one
    micro-step (forward + backward) of Monodepth2-M as it stands (ConvNeXt-B depth net,
    ResNet-18 pose net), `abl_pretrained/resnet18` and `abl_pretrained/resnext101_pt_ssl`
    on the kernel path and on the plain path from the same seeded weights and batch: the
    loss, every gradient and every BatchNorm running statistic held to the plain path's;
    launches per kernel; device ms per micro-step and peak memory. Then
    `abl_pretrained/resnet18` through `MonoDepthLoop` (2 epochs of 2 batches and a
    validation batch each), its `last.ckpt` with every buffer, served by
    `BenchmarkPredictor` at B=12 and held to the trainer's eval-mode forward."""
    from slowtv_monodepth_tpu_torch.core import BenchmarkPredictor, load_checkpoint
    t0 = time.perf_counter()
    loader = SceneLoader(scenes, 1, FAMILY_SHAPE, batch=FAMILY_B)
    for i, name in enumerate(RESNET_FILE_CFGS):
        cfg = resnet_cfg(name)
        x, y, supp, noise = _step_inputs(cfg, loader, RUN_SEED + 20 + i)
        passes, times, peaks, notes = _both_paths(cfg, x, y, supp, noise, f'resnet {name}',
                                                  RESNET_LAUNCHES[name])
        got_counts = {k: passes[True]['counts'][k] for k in RESNET_LAUNCHES[name]}
        k_ms, p_ms = times[True], times[False]
        nets = {n: v['enc_name'] for n, v in cfg['net'].items() if v}
        print(f'resnet {name} (nets {nets}, B={FAMILY_B}, {FAMILY_SHAPE[0]}x{FAMILY_SHAPE[1]}, '
              f'supports {list(supp)}): loss {passes[True]["loss"]:.6f} (plain '
              f'{passes[False]["loss"]:.6f}, rtol 1e-5); gradients within 1e-3 and running '
              f'statistics within {BN_STATS_RTOL:.0e} of each tensor\'s largest: '
              + '; '.join(notes) + f'; every one of {passes[True]["n_params"]} parameters with a '
              f'finite non-zero gradient; launches per micro-step {got_counts}; device ms per '
              f'micro-step (forward + backward, no update; eager in brackets, timed by '
              f'{k_ms.how}/{p_ms.how}): kernel {k_ms.ms:.2f} ({k_ms.eager_ms:.2f}), plain '
              f'{p_ms.ms:.2f} ({p_ms.eager_ms:.2f}); peak memory kernel {peaks[True]:.2f} '
              f'GiB, plain {peaks[False]:.2f} GiB on {smi}')
        del passes
        torch.cuda.empty_cache()

    # Train -> checkpoint -> serve, as `slowtv-train-torch` and `export_preds` run them.
    cfg = resnet_cfg(RESNET_RUN)
    cfg = {**cfg, 'seed': RUN_SEED, 'trainer': {
        **cfg['trainer'], 'max_epochs': FAMILY_RUN_EPOCHS, 'log_every_n_steps': 1,
        'limit_val_batches': 1, 'matmul': 'highest'}}
    n = FAMILY_RUN_EPOCHS * FAMILY_RUN_BATCHES
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp) / 'run'
        loop, st = _run_loop(cfg, run, scenes, val=True, tag=f'resnet {RESNET_RUN}', loaders=(
            PackLoader(scenes, 'kitti_lmdb', FAMILY_RUN_BATCHES, FAMILY_SHAPE, True, RUN_SEED,
                       batch=FAMILY_B),
            PackLoader(scenes, 'kitti_lmdb', 1, FAMILY_SHAPE, False, RUN_SEED + 1, batch=FAMILY_B)))
        counts = st['counts']
        if loop.global_step != n or counts['decoder_stage_bwd'] != n or counts['dwconv'] \
                or counts['decoder_stage'] != n + FAMILY_RUN_EPOCHS:
            fail(f'resnet run: {loop.global_step} micro-steps, launches {counts}')
        sd, ckpt_cfg = load_checkpoint(run / 'last.ckpt')
        live = {f'nets.{k}.{kk}': v for k, net in loop.trainer.nets.items()
                for kk, v in net.state_dict().items()}
        buffers = [k for k in live if 'running' in k or k.endswith('num_batches_tracked')]
        stale = [k for k in buffers if not torch.equal(sd[k], live[k].cpu())]
        counters = {int(sd[k]) for k in buffers if k.endswith('num_batches_tracked')}
        if sorted(sd) != sorted(live) or not buffers or stale or counters != {n} \
                or any(sd[k].dtype != torch.int64 for k in buffers if 'running' not in k):
            fail(f'resnet run: last.ckpt has {len(sd)} of {len(live)} tensors, buffers '
                 f'{len(buffers)}, stale {stale[:3]}, counters {counters}')
        predictor = BenchmarkPredictor('cuda')
        net = predictor.load_model(run / 'last.ckpt')
        std = PackLoader(scenes, 'kitti_lmdb', 1, FAMILY_SHAPE, False).std  # a frame a scene
        imgs = std[np.arange(RESNET_SERVE_B) % len(std)]
        t = torch.from_numpy(np.ascontiguousarray(imgs)).cuda().permute(0, 3, 1, 2)
        _reset_counts()
        with torch.no_grad():
            got = predictor.forward(net, t)
            served = _read_counts()
            want = loop.trainer.nets['depth'].eval()(t)['disp'][0]
        torch.cuda.synchronize()
        err = _max_err(got, want)
        if net.training or got.shape != (RESNET_SERVE_B, 1) + FAMILY_SHAPE or err > GOLDEN_ATOL \
                or served['decoder_stage'] != 1 or served['dwconv']:
            fail(f'resnet serve: output {tuple(got.shape)} off the trainer\'s eval forward by '
                 f'{err:.2e}, launches {served}')
        print(f'resnet run {RESNET_RUN}: {FAMILY_RUN_EPOCHS} epochs x {FAMILY_RUN_BATCHES} '
              f'batches of {FAMILY_B} at {FAMILY_SHAPE[0]}x{FAMILY_SHAPE[1]}, launches '
              f'{counts}; last.ckpt {len(sd)} tensors, {len(buffers)} BatchNorm buffers equal '
              f'to the trainer\'s, counters {sorted(counters)} (int64); BenchmarkPredictor '
              f'serves it at B={RESNET_SERVE_B} in eval mode ({served["decoder_stage"]} '
              f'decoder_stage launch per forward), {err:.2e} off the trainer\'s eval-mode '
              f'forward (bound {GOLDEN_ATOL:.0e}) on {smi}')
        del loop, net, predictor
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    print(f'resnet: phase wall {time.perf_counter() - t0:.1f} s')


def profile_train(out: Path = ROOT / 'build' / 'train_profile.txt',
                  matmul: str = 'highest', fused_blocks: bool = False) -> None:
    """Where the KBR micro-step's device time goes (not part of `main`).

    `python3 -c 'import chip_smoke; chip_smoke.profile_train()'` times 5 warm
    micro-steps of the kernel path, runs 2 more under `torch.profiler`, and
    writes the device time per kernel and per category to `out` (a path
    relative to the working directory, or under `build/` by default).
    `matmul` is `torch.set_float32_matmul_precision`'s argument: 'highest'
    (exact float32, the numerics of `main`) or 'high' (TF32 matmuls, the KBR
    recipe's `trainer.matmul`). `fused_blocks` runs both nets' ConvNeXt
    blocks as kernels 9 and 10.
    """
    out = Path(out)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from slowtv_monodepth_tpu_torch import parsers
    from slowtv_monodepth_tpu_torch.models import seeded_state_dict
    phase_device()
    torch.set_float32_matmul_precision(matmul)
    with torch.device('meta'):
        meta = parsers.get_net(KBR_TRAIN_CFG['net'])
    weights = {k: {kk: torch.from_numpy(v) for kk, v in seeded_state_dict(net, 0).items()}
               for k, net in meta.items()}
    x, y = _train_batch(_make_scenes())
    gen = torch.Generator(device='cuda').manual_seed(0)
    step = _build_trainer(True, weights, fused_blocks=fused_blocks)[2]
    for _ in range(3):
        step(x, y, gen)['loss'].item()
    torch.cuda.reset_peak_memory_stats()
    wall = float(np.median(_time_steps(step, x, y, gen)))  # without the profiler
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(x, y, gen)['loss'].item()
    rows = [(e.key, e.self_device_time_total / 1e3 / 2, e.count // 2)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False) and not e.key.startswith('Optimizer.')]
    rows.sort(key=lambda r: -r[1])
    device = sum(r[1] for r in rows)
    cats = {'hand-written kernels': ('dwconv_', 'warp_bilinear', 'photo_', 'decoder_stage_fwd_',
                                     'sigmoid_grad', 'reduce_weight_grad', 'presum_kernel',
                                     'weight_grad_kernel', 'input_grad_kernel',
                                     'convnext_block_'),
            'convolution (cuDNN)': ('conv', 'cudnn', 'fprop', 'dgrad', 'wgrad', 'fft',
                                    'winograd'),  # before GEMM: implicit-GEMM convs
            'GEMM (cuBLAS/CUTLASS)': ('gemm',),
            'optimizer (foreach)': ('multi_tensor',),
            'normalization': ('layer_norm', 'LayerNorm'),
            'reduction': ('reduce_kernel',)}
    totals = dict.fromkeys(list(cats) + ['elementwise and other'], 0.0)
    for name, ms, _ in rows:
        cat = next((c for c, keys in cats.items() if any(k in name for k in keys)),
                   'elementwise and other')
        totals[cat] += ms
    lines = [f"KBR micro-step, kernel path, B={TRAIN_B}, 384x640, float32 matmul '{matmul}', "
             f'fused_blocks {fused_blocks}: wall {wall:.2f} ms (median of 5, no profiler), peak '
             f'memory {peak:.2f} GiB, device {device:.2f} ms in '
             f'{sum(r[2] for r in rows)} kernel launches (under the profiler) per micro-step: '
             f'idle {100 * (1 - device / wall):.1f}%']
    lines += [f'{c:28s} {ms:9.3f} ms {100 * ms / device:5.1f}%' for c, ms in
              sorted(totals.items(), key=lambda kv: -kv[1])]
    # The hand-written kernels' CUDA launches by the TPU kernel each replaces.
    by_row = {'1 dwconv': ('dwconv_fwd_kernel',), '2 dwconv_dw': ('dwconv_dw_',),
              '3 decoder_stage': ('decoder_stage_fwd_',),
              '4 decoder_stage_bwd': ('sigmoid_grad', 'presum_kernel', 'weight_grad_kernel',
                                      'input_grad_kernel', 'reduce_weight_grad'),
              '5 warp': ('warp_bilinear_kernel<float',),
              '6 warp_packed': ('warp_bilinear_kernel<unsigned short',),
              '7 photo_fwd': ('photo_fwd',), '8 photo_bwd': ('photo_bwd',),
              '9 convnext_block': ('convnext_block_fwd',),
              '10 convnext_block_bwd': ('convnext_block_bwd_',)}
    lines += ['', 'TPU kernel (device time per micro-step, CUDA launches per micro-step):']
    for row, keys in by_row.items():
        hits = [(ms, n) for name, ms, n in rows if any(k in name for k in keys)]
        lines.append(f'{row:28s} {sum(h[0] for h in hits):9.3f} ms {sum(h[1] for h in hits):6d}')
    lines += ['', 'kernel (self device time per micro-step, launches per micro-step):']
    lines += [f'{ms:9.3f} ms {n:6d}  {name[:150]}' for name, ms, n in rows[:60]]
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text('\n'.join(lines) + '\n')
    print('\n'.join(lines[:30]))


def main() -> None:
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    kern = phase_kernels()
    sd = phase_golden()
    scenes = _make_scenes()
    launches = phase_slice(sd, scenes)
    kern.update(phase_train_kernels(scenes))
    phase_train_golden()
    train_launches, trainer = phase_train(scenes)
    phase_train_to_serve(trainer, scenes)
    del trainer
    torch.cuda.empty_cache()
    phase_train_golden(fused_blocks=True)
    fused_launches, _ = phase_train(scenes, fused_blocks=True)
    torch.cuda.empty_cache()
    run_launches = phase_run(scenes)
    phase_recipe(scenes)
    phase_published_run(scenes)
    phase_optimizers(scenes)
    phase_train_dev(scenes)
    phase_eval(sd, scenes, smi)
    phase_eval_zero_shot(sd, scenes, smi)
    phase_families(scenes, smi)
    phase_resnet(scenes, smi)
    sources = {'dwconv': ('dwconv.cu', 'pallas_dwconv.py:59'),
               'decoder_stage': ('decoder_stage.cu', 'pallas_decoder.py:249'),
               'decoder_stage_bwd': ('decoder_stage_bwd.cu', 'pallas_decoder.py:268'),
               'dwconv_dw': ('dwconv.cu', 'pallas_dwconv.py:75'),
               'warp': ('warp.cu', 'pallas_warp.py:130'),
               'warp_packed': ('warp.cu', 'pallas_warp.py:225'),
               'photo_fwd': ('photo.cu', 'pallas_photo.py:116'),
               'photo_bwd': ('photo_bwd.cu', 'pallas_photo.py:159'),
               'convnext_block': ('convnext_block.cu', 'pallas_convnext.py:147'),
               'convnext_block_bwd': ('convnext_block_bwd.cu', 'pallas_convnext.py:234')}
    # Launches: the serving slice's for kernels 1 and 3, its fused-blocks half
    # for 9, the training slice's for 2, 5, 7, 8, the training run's for 4 and 6,
    # the fused training slice's for 10.
    counts = {**train_launches, **launches,
              **{k: run_launches[k] for k in ('decoder_stage_bwd', 'warp_packed')},
              'convnext_block_bwd': fused_launches['convnext_block_bwd']}
    if not all(counts[name] > 0 and (run_launches[name] > 0 or name.startswith('convnext_block'))
               for name in sources):  # the run trains with the blocks unfused
        fail(f'a kernel was never launched on its main path: {counts}, run {run_launches}')
    line = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': f'slowtv_monodepth_tpu_torch/csrc/{src}',
         'replaces': f'slowtv_monodepth_tpu/ops/{rep}', 'launches': counts[name],
         'max_abs_err': kern[name]['err'], 'ms': kern[name]['ms'],
         'plain_ms': kern[name]['plain_ms'], 'bound_ms': kern[name]['bound_ms'],
         'bound_by': ('bytes' if kern[name]['bound_bytes_ms'] >= kern[name]['bound_ops_ms']
                      else 'operations'),
         'library_ms': kern[name]['library_ms'], 'eager_ms': kern[name]['eager_ms'],
         'plain_eager_ms': kern[name]['plain_eager_ms'],
         'library_eager_ms': kern[name]['library_eager_ms'], 'timed_by': kern[name]['timed_by']}
        for name, (src, rep) in sources.items()]}
    rows = {row['name']: row for row in line['kernels']}
    for name, step in (('dwconv', kern['dwconv_step']),  # its 108 launches per KBR micro-step
                       ('convnext_block', kern['convnext_block']['step']),  # 54, blocks fused
                       ('decoder_stage', kern['decoder_stage_step'])):  # 2 stages at B=4
        rows[name].update({f'step_{k}': step[k] for k in (
            'ms', 'plain_ms', 'library_ms', 'bound_ms', 'eager_ms', 'plain_eager_ms')})
    rows['decoder_stage'].update({f'b1_{k}': kern['decoder_stage_b1'][k] for k in (
        'ms', 'plain_ms', 'library_ms', 'bound_ms', 'eager_ms', 'plain_eager_ms')})
    print('(launches: dwconv and decoder_stage in the serving slice, convnext_block in its '
          "fused-blocks half, decoder_stage_bwd in the training run's first epoch, warp_packed in "
          'its bf16 epoch, the others in the training slice; ms / plain_ms / bound_ms / library_ms: '
          'device time per ConvNeXt-B + decoder forward at B=2, 384x640, for dwconv and '
          'decoder_stage (dwconv step_*: its 108 launches per KBR micro-step; decoder_stage '
          'step_*: its 2 stages per KBR micro-step, b1_*: per request at B=1), per request (36 blocks at B=1, 384x640) for convnext_block (step_*: its 54 launches per KBR micro-step with fused blocks), per KBR '
          'micro-step at B=4, 384x640 for the others; convnext_block max_abs_err is relative to '
          'max|y|; bound_ms from 67 TFLOP/s float32 and 3.35 TB/s; photo_bwd and '
          "decoder_stage_bwd max_abs_err are relative to the gradient's own largest magnitude; "
          'convnext_block_bwd: launches in the fused training slice; ms, plain_ms and bound_ms '
          'over the whole block backward (kernel 10, then kernels 1 and 2) for its 54 blocks per '
          'micro-step; max_abs_err the worst of its ten gradients, each relative to its own largest '
          'magnitude; ms, plain_ms, library_ms: device time (CUDA graph of the calls, one replay; '
          'timed_by says where torch.profiler stood in); eager_ms, plain_eager_ms, '
          'library_eager_ms: CUDA events around the same calls made from Python; '
          f'total run {time.perf_counter() - t0:.0f} s)')
    print(json.dumps(line))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
