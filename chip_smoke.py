#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, KBR training step and KBR training run on
one NVIDIA GPU (H100).

Phases, in order; any failure exits non-zero and prints no result:
1. device: require CUDA, print the card's name and power limit, pin exact
   float32 numerics (no TF32 in cuDNN convs or matmuls).
2. build: compile the port's CUDA kernels from `slowtv_monodepth_tpu_torch/csrc`.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the serving path's shapes (B=2), ragged shapes and the shapes
   two of the training run's augmentation buckets give it; times both. The
   fused ConvNeXt block (kernel 9) is held to its plain version in float64,
   erf and tanh, and timed at the four ConvNeXt-B stage shapes at B=1 and B=4.
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
   under grad raises). Times warm requests at B=1 and B=4 on the kernel
   path, with the fused blocks on, and on the plain path.
6. training kernels: the tap gradient (kernel 2), the decoder stage's
   backward (4), the warp on float32 (5) and on packed bfloat16 sources (6)
   and the photometric error forward and backward (7, 8) against their plain
   versions (in float64) at the training step's shapes (B=4, 384x640), ragged
   shapes and the run's shapes (two of its augmentation buckets, the warp also
   from 720x1280 sources at the coords the augmentation gives it); times
   kernel, plain and, where one PyTorch call computes the function, that call
   (float32). Kernel 6 is also held to kernel 5 on the
   widened source.
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
The last two lines are a JSON object per kernel and the contract line
`{"ok": true, "device": {...}}`.

Usage: python3 chip_smoke.py   (from the repo root, one CUDA card)
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import tempfile
import time
from pathlib import Path

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
                  'convnext_block': 0}  # training builds its nets with the blocks unfused
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
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
CONVNEXT_B_BLOCKS = (3, 3, 27, 3)
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
WARP_ATOL = 1e-5     # 4-corner bilinear of values in [0, 1]
# The stage's backward, each gradient relative to its own largest magnitude
# (a gradient that is exactly zero must come out exactly zero): 1e-5 for dx,
# and for the weight and bias gradients (sums over P = b*2h*2w pixels)
# 1e-5 * max(1, sqrt(P) / 16).
STAGE_BWD_RTOL = 1e-5
BF16_LOSS_RTOL = 5e-3  # first-step loss, bfloat16 warp sources (8 mantissa bits) vs float32
# The photometric error's statistics are variances by cancellation,
# P(x^2) - P(x)^2, as in the reference: in float32 on smooth image regions
# (a sky) they carry ~1e-7 absolute error against c2 = 9e-4, so the map and
# its gradient are good to ~1e-4 there. The kernel (float32) is held to
# twice the plain version's own float32 error against float64, plus:
PHOTO_ATOL = 1e-5      # of the error map (in [0, 1])
PHOTO_BWD_RTOL = 1e-5  # of the largest |gradient|


def fail(msg: str) -> None:
    raise SystemExit(f'chip_smoke FAILED: {msg}')


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of `fn()` in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float) -> tuple[float, float]:
    """(ms to move `n_bytes` at the card's memory rate, ms for `flops` float32
    operations at its peak rate); the larger is the least time the card could take."""
    return 1e3 * n_bytes / PEAK_BYTES, 1e3 * flops / PEAK_F32_FLOPS


def new_result() -> dict:
    return {'err': 0.0, 'ms': 0.0, 'plain_ms': 0.0, 'library_ms': None, 'bound_ms': 0.0,
            'bound_bytes_ms': 0.0, 'bound_ops_ms': 0.0}


def add_times(r: dict, n: int, ms: float, plain_ms: float, bound: tuple, library_ms=None) -> str:
    """Add `n` launches' times per main path to a kernel's result -> text for the log."""
    r['ms'] += n * ms
    r['plain_ms'] += n * plain_ms
    r['bound_ms'] += n * max(bound)
    r['bound_bytes_ms'] += n * bound[0]
    r['bound_ops_ms'] += n * bound[1]
    text = (f'; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {max(bound):.4f} ms '
            f'({"bytes" if bound[0] >= bound[1] else "operations"})')
    if library_ms is not None:
        r['library_ms'] = (r['library_ms'] or 0.0) + n * library_ms
        text += f', library {library_ms:.4f} ms'
    return text + f', x{n} per main path'


def run_buckets() -> list[tuple[tuple[int, int], tuple[int, int]]]:
    """(crop, bucket shape) of `RUN_CROPS` under the run's augmentation settings."""
    from slowtv_monodepth_tpu_torch.core.aspect_ratio import sample_resize
    ref = RUN_CFG['trainer']['aspect_ratio_ref_shape']
    return [(crop, sample_resize(crop, ref, eps=0.8)) for crop in RUN_CROPS]


def stage_cost(b, h, w, ci, cd, backward: bool) -> tuple[float, float]:
    """(bytes, float32 operations) of one decoder stage, forward or backward."""
    p = b * h * w
    conv_flops = 2 * 9 * (ci * cd * p + cd * cd * 4 * p + cd * 4 * p)
    params = 9 * (ci * cd + cd * cd + cd) + 2 * cd + 1
    x, ha, feat, disp = p * ci, p * cd, 4 * p * cd, 4 * p
    if not backward:  # reads x and the parameters, writes feat and disp
        return 4 * (x + params + feat + disp), conv_flops
    # reads x, the weights, ha, feat, disp and both cotangents; writes seven gradients;
    # each conv has an input and a weight gradient of the forward's cost each.
    return 4 * (x + params + ha + 2 * feat + 2 * disp + x + params), 2 * conv_flops


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
        if 'convnext_block_fwd_kernel' in entry and 'spill' in line \
                and '0 bytes spill stores, 0 bytes spill loads' not in line:
            fail(f'the fused ConvNeXt block kernel spills registers: {line.strip()}')
    if 'convnext_block_fwd_kernel' not in log:
        fail('the build log does not show the fused ConvNeXt block kernel')


def _rand(rs, *shape, scale=1.0):
    return torch.from_numpy((scale * rs.standard_normal(shape)).astype(np.float32)).cuda()


def phase_kernels() -> dict:
    from slowtv_monodepth_tpu_torch.ops import (depthwise_conv, depthwise_conv_plain,
                                                fused_upconv_stage, fused_upconv_stage_plain)
    import torch.nn.functional as F
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

    # (b, h, w, ci, cd, stages per forward): KBR stages 1 and 0 at B=2
    # (timed) and B=1, then ragged ones.
    st_cases = [(2, 96, 160, 64, 32, 1), (2, 192, 320, 32, 16, 1),
                (1, 96, 160, 64, 32, 0), (1, 192, 320, 32, 16, 0),
                (2, 23, 37, 6, 5, 0), (1, 21, 19, 20, 20, 0)]
    for _, (bh, bw) in run_buckets():  # the training run's buckets at B=4, stages 1 and 0
        st_cases += [(4, bh // 4, bw // 4, 64, 32, 0), (4, bh // 2, bw // 2, 32, 16, 0)]
    for b, h, w, ci, cd, n in st_cases:
        args = (_rand(rs, b, h, w, ci, scale=0.5),
                _rand(rs, cd, ci, 3, 3, scale=1 / np.sqrt(9 * ci)), _rand(rs, cd, scale=0.1),
                _rand(rs, cd, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), _rand(rs, cd, scale=0.1),
                _rand(rs, 1, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), _rand(rs, 1, scale=0.1))
        (fk, dk), (fp, dp) = fused_upconv_stage(*args), fused_upconv_stage_plain(*args)
        err = max((fk - fp).abs().max().item(), (dk - dp).abs().max().item())
        torch.cuda.synchronize()
        res['decoder_stage']['err'] = max(res['decoder_stage']['err'], err)
        line = (f'decoder_stage {(b, h, w, ci)} -> cd={cd}: max|kernel-plain| '
                f'{err:.2e} (tol {STAGE_ATOL:.0e})')
        if n:
            ms = cuda_ms(lambda: fused_upconv_stage(*args))
            pms = cuda_ms(lambda: fused_upconv_stage_plain(*args))
            # Library: cuDNN for the stage's three convs alone (zero padding
            # in the call, no ELU, upsample or sigmoid).
            xa = args[0].permute(0, 3, 1, 2)
            ub = torch.empty(b, cd, 2 * h, 2 * w, device='cuda').contiguous(
                memory_format=torch.channels_last)
            lms = cuda_ms(lambda: (F.conv2d(xa, args[1], args[2], padding=1),
                                   F.conv2d(ub, args[3], args[4], padding=1),
                                   F.conv2d(ub, args[5], args[6], padding=1)))
            line += add_times(res['decoder_stage'], n, ms, pms,
                              bound_ms(*stage_cost(b, h, w, ci, cd, False)), lms)
        print(line)
        if not err <= STAGE_ATOL:
            fail(line)
    res['convnext_block'] = _block_kernel_cases(rs)
    torch.cuda.synchronize()
    return res


def block_cost(b, h, w, c) -> tuple[float, float]:
    """(bytes, float32 operations) of one ConvNeXt block: x in and y out, the
    parameters once; the two matrix products (16 C^2 per pixel) and the 49 taps."""
    p = b * h * w
    return 4 * (2 * p * c + 8 * c * c + 49 * c + 9 * c), 16 * p * c * c + 98 * p * c


def block_bwd_cost(b, h, w, c) -> tuple[float, float]:
    """(bytes, float32 operations) of the fused block's backward (the TPU kernel
    `pallas_convnext.py:_block_bwd_jit`, not ported yet): both forward products
    again and four more of their size (two input gradients, two weight
    gradients: 48 C^2 per pixel in all), the taps forward and their two
    transposes; x and dy in, dx out, the parameters in and their gradients out."""
    p = b * h * w
    return 4 * (3 * p * c + 2 * (8 * c * c + 49 * c + 9 * c)), 48 * p * c * c + 3 * 98 * p * c


def _block_kernel_cases(rs) -> dict:
    """Kernel 9 against the unfused block in float64; times at the ConvNeXt-B shapes."""
    from slowtv_monodepth_tpu_torch.ops import (depthwise_conv, fused_convnext_block,
                                                fused_convnext_block_plain)
    from slowtv_monodepth_tpu_torch.ops.convnext_block import tile_pixels
    import torch.nn.functional as F
    res = new_result()
    stages = list(zip((96, 48, 24, 12), (160, 80, 40, 20), (128, 256, 512, 1024),
                      CONVNEXT_B_BLOCKS))
    # (b, h, w, c): the four stage shapes at B=2 and at B=1 (where clusters of 4
    # and 8 blocks share a tile), ragged shapes (pixel counts off every tile,
    # heights under the 7x7 halo, channels off 32 and 256), then what a request
    # at two of the run's bucket shapes gives the first and last stage.
    cases = [(b, h, w, c) for b in (2, 1) for h, w, c, _ in stages]
    cases += [(2, 37, 53, 160), (1, 5, 7, 96), (1, 3, 4, 40), (3, 9, 9, 264), (1, 7, 11, 1536)]
    for _, (bh, bw) in run_buckets():
        cases += [(1, bh // 4, bw // 4, 128), (1, bh // 32, bw // 32, 1024)]

    def make(b, h, w, c):
        return (_rand(rs, b, h, w, c), _rand(rs, c, 1, 7, 7, scale=1 / 7), _rand(rs, c, scale=0.1),
                1 + _rand(rs, c, scale=0.1), _rand(rs, c, scale=0.1),
                _rand(rs, 4 * c, c, scale=c ** -0.5), _rand(rs, 4 * c, scale=0.1),
                _rand(rs, c, 4 * c, scale=(4 * c) ** -0.5), _rand(rs, c, scale=0.1),
                _rand(rs, c, scale=0.5))

    for shape in cases:
        args = make(*shape)
        for approximate in (False, True):
            want = fused_convnext_block_plain(*(t.double() for t in args), approximate=approximate)
            got = fused_convnext_block(*args, approximate=approximate)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            err = _max_err(got, want) / scale
            p32 = _max_err(fused_convnext_block_plain(*args, approximate=approximate), want) / scale
            res['err'] = max(res['err'], err)
            line = (f'convnext_block {shape} {"tanh" if approximate else "erf"}: max|kernel-plain(f64)| '
                    f'/ max|y| {err:.2e} (tol {BLOCK_RTOL:.0e}; plain f32 {p32:.2e}; max|y| {scale:.2f})')
            print(line)
            if not err <= BLOCK_RTOL:
                fail(line)

    def unfused(x, dww, dwb, lnw, lnb, w1, b1, w2, b2, gamma):
        """The block as the net runs it with the blocks unfused: kernel 1, then
        PyTorch's LayerNorm and cuBLAS."""
        u = F.layer_norm(depthwise_conv(x, dww, dwb), (x.shape[-1],), lnw, lnb, 1e-6)
        return x + gamma * F.linear(F.gelu(F.linear(u, w1, b1)), w2, b2)

    # Times: a request is B=1 (what the kernels line carries), a batch B=4.
    for b in (1, 4):
        total = new_result()
        for h, w, c, n in stages:
            args = make(b, h, w, c)
            ms = cuda_ms(lambda: fused_convnext_block(*args), iters=10)
            pms = cuda_ms(lambda: fused_convnext_block_plain(*args), iters=10)
            ums = cuda_ms(lambda: unfused(*args), iters=10)
            cost = block_cost(b, h, w, c)
            m, s = tile_pixels(b * h * w, c)
            times = add_times(res if b == 1 else total, n, ms, pms, bound_ms(*cost))
            print(f'convnext_block {(b, h, w, c)}: tiles of {m} pixels, {s} block(s) each, '
                  f'{cost[1] / ms / 1e9:.1f} TFLOP/s; unfused with kernel 1 {ums:.4f} ms{times}')
            total['unfused'] = total.get('unfused', 0.0) + n * ums
        t = res if b == 1 else total
        print(f'convnext_block, 36 blocks at B={b}: kernel {t["ms"]:.3f} ms, plain {t["plain_ms"]:.3f} '
              f'ms, unfused with kernel 1 {total["unfused"]:.3f} ms, bound {t["bound_ms"]:.3f} ms')
    # The backward's bound, from the shapes alone: the KBR micro-step at B=4 with
    # every block fused would launch it for 36 ConvNeXt-B blocks and for the 18
    # ConvNeXt-T blocks of the pose net on its 2 x 4 image pairs.
    bwd = [bound_ms(*block_bwd_cost(TRAIN_B, h, w, c)) for h, w, c, n in stages for _ in range(n)]
    bwd += [bound_ms(*block_bwd_cost(2 * TRAIN_B, h, w, c)) for h, w, c, n in
            zip((96, 48, 24, 12), (160, 80, 40, 20), (96, 192, 384, 768), (3, 3, 9, 3))
            for _ in range(n)]
    print(f'convnext_block backward (not ported yet): {len(bwd)} launches per KBR micro-step at '
          f'B={TRAIN_B}, 384x640, with every block fused; bound {sum(max(t) for t in bwd):.3f} ms '
          f'({"operations" if all(t[1] >= t[0] for t in bwd) else "mixed"})')
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
    try:  # no backward kernel yet: under grad the card must refuse, not cut autograd
        fused(x)
    except NotImplementedError as e:
        if 'kernel 10' not in str(e):
            raise
        print('slice, fused blocks: a forward under grad raises (the backward kernel is open)')
    else:
        fail('a forward of the fused blocks under grad did not raise')
    if fused_convnext_block.launches != n_blocks:
        fail('the refused forward launched the kernel')

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
    res = {k: new_result() for k in ('dwconv_dw', 'decoder_stage_bwd', 'warp', 'warp_packed',
                                     'photo_fwd', 'photo_bwd')}

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
    for b, h, w, c, k, n in dw_cases:
        x = _rand(rs, b, h, w, c)
        g = _rand(rs, b, h, w, c, scale=1 / np.sqrt(b * h * w))
        err = _max_err(dwconv.dwconv_dw(x, g, k), dwconv.dwconv_dw_plain(x.double(), g.double(), k))
        px = b * h * w * c  # the plain version IS the library call (cuDNN's weight gradient)
        record('dwconv_dw', err, DW_ATOL, f'dwconv_dw {(b, h, w, c)} k={k}', n,
               lambda: dwconv.dwconv_dw(x, g, k), lambda: dwconv.dwconv_dw_plain(x, g, k),
               (4 * (2 * px + k * k * c), 2 * k * k * px), 'plain')

    # The decoder stage's backward (kernel 4) through the autograd Function:
    # KBR stages 1 and 0 at B=4 (timed), ragged shapes, grids of 2 and 3
    # where a reflect fold lands on the row it left, both stages at the run's
    # augmentation buckets; with both cotangents, g_feat alone and g_disp alone.
    names = ('dx', 'dwa', 'dba', 'dwb', 'dbb', 'dwo', 'dbo')
    st_cases = [(4, 96, 160, 64, 32, 1), (4, 192, 320, 32, 16, 1), (2, 23, 37, 6, 5, 0),
                (1, 21, 19, 20, 20, 0), (1, 2, 3, 4, 3, 0), (2, 3, 2, 2, 2, 0),
                (4, 56, 176, 32, 16, 0)]
    for _, (bh, bw) in run_buckets():
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

    def library_warp(im, cx, cy):
        """`F.grid_sample` on the same samples (it returns the sample only, not ddx, ddy)."""
        h, w = im.shape[1:3]
        grid = torch.stack([(2 * cx + 1) / w - 1, (2 * cy + 1) / h - 1], -1)
        return lambda: F.grid_sample(im.float().permute(0, 3, 1, 2), grid, mode='bilinear',
                                     padding_mode='border', align_corners=False)

    for im, cx, cy, n in cases:
        got = sample.warp_bilinear(im, cx, cy)
        want = sample.warp_bilinear_plain(im.double(), cx.double(), cy.double())
        px, pout = im.numel(), got[0].numel()
        lib = library_warp(im, cx, cy)
        lib_err = _max_err(lib().permute(0, 2, 3, 1), want[0])
        record('warp', max(_max_err(a, b) for a, b in zip(got, want)), WARP_ATOL,
               f'warp {tuple(im.shape)} -> {tuple(cx.shape[1:])} (F.grid_sample off by '
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
        record('warp_packed', max(_max_err(a, b) for a, b in zip(got16, want16)), WARP_ATOL,
               f'warp_packed {tuple(im.shape)} bf16 -> {tuple(cx.shape[1:])} (vs kernel 5 on the '
               f'widened source {vs_k5:.1e})', n, lambda: sample.warp_bilinear(im16, cx, cy),
               lambda: sample.warp_bilinear_plain(im16, cx, cy),
               (2 * px + 4 * (2 * cx.numel() + 3 * pout), 14 * pout),
               library_warp(im16, cx, cy))  # the library call on the source widened in the call

    # Photometric error: the warped stack (m=32) and the static stack (m=8)
    # forward, the warped stack backward; then ragged shapes with exact ties.
    for mm, n_fwd, n_bwd in [(m, 1, 1), (2 * TRAIN_B, 1, 0)]:
        x, y = _scene_pair(scenes, mm, rs)
        g = torch.from_numpy(rs.rand(mm, 384, 640).astype(np.float32)).cuda()
        _photo_case(record, x, y, g, n_fwd, n_bwd)
    for _, (bh, bw) in run_buckets():  # the warped and the static stack at the run's buckets
        for mm in (m, 2 * TRAIN_B):
            x, y = (F.interpolate(t.permute(0, 3, 1, 2), size=(bh, bw), mode='bilinear',
                                  align_corners=False).permute(0, 2, 3, 1).contiguous()
                    for t in _scene_pair(scenes, mm, rs))
            g = torch.from_numpy(rs.rand(mm, bh, bw).astype(np.float32)).cuda()
            _photo_case(record, x, y, g, 0, 0)
    for shape in [(2, 37, 70, 3), (1, 2, 2, 3), (3, 19, 33, 1)]:
        x = torch.from_numpy(rs.rand(*shape).astype(np.float32)).cuda()
        y = torch.from_numpy(rs.rand(*shape).astype(np.float32)).cuda()
        y[:, :, : shape[2] // 2] = x[:, :, : shape[2] // 2]  # x == y: S == 0 exactly
        _photo_case(record, x, y, torch.from_numpy(rs.rand(*shape[:3]).astype(np.float32)).cuda(),
                    0, 0)
    torch.cuda.synchronize()
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
    err = max(_max_err(a, b) for a, b in zip(photo.photo_bwd(x, y, g, 0.85), want))
    record('photo_bwd', err / scale, PHOTO_BWD_RTOL + 2 * plain32 / scale,
           f'photo_bwd {tuple(x.shape)} (relative to max|grad| {scale:.3g}; plain f32 '
           f'{plain32 / scale:.2e})', n_bwd,
           lambda: photo.photo_bwd(x, y, g, 0.85), lambda: photo.photo_bwd_plain(x, y, g, 0.85),
           (4 * (4 * px + g.numel()), 250 * px))


def phase_train_golden() -> None:
    from slowtv_monodepth_tpu_torch import train_golden as tg
    gold = tg.load_fixture()
    got = tg.port_step(gold, 'cuda', kernels=True)
    rel = np.abs(got['grad_norms'] - gold['grad_norms']) / gold['grad_norms']
    print(f'train golden (ConvNeXt-B + ConvNeXt-T, B=2, 64x96): loss {got["loss"]:.7f} vs JAX '
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


def _build_trainer(kernels: bool, weights: dict):
    from slowtv_monodepth_tpu_torch import parsers
    from slowtv_monodepth_tpu_torch.core.trainer import MonoDepthTrainer
    trainer = MonoDepthTrainer(KBR_TRAIN_CFG, kernels=kernels)
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


def phase_train(scenes) -> tuple[dict, object]:
    from slowtv_monodepth_tpu_torch import parsers
    from slowtv_monodepth_tpu_torch.models import seeded_state_dict
    with torch.device('meta'):
        meta = parsers.get_net(KBR_TRAIN_CFG['net'])
    weights = {k: {kk: torch.from_numpy(v) for kk, v in seeded_state_dict(net, 0).items()}
               for k, net in meta.items()}
    x, y = _train_batch(scenes)
    gen = torch.Generator(device='cuda').manual_seed(0)

    torch.cuda.reset_peak_memory_stats()
    trainer, opt, step = _build_trainer(True, weights)
    totals, losses = {k: 0 for k in TRAIN_LAUNCHES}, []
    for micro in range(TRAIN_UPDATES * opt.accumulate):
        _reset_counts()
        losses.append(step(x, y, gen)['loss'].item())
        counts = _read_counts()
        totals = {k: totals[k] + counts[k] for k in totals}
        if counts != TRAIN_LAUNCHES:
            fail(f'micro-step {micro}: launch counts {counts}, expected {TRAIN_LAUNCHES}')
        if micro == 0:  # micro-step 1's gradients, still held for the accumulation
            for name, net in trainer.nets.items():
                for k, p in net.named_parameters():
                    if p.grad is None or not bool(torch.isfinite(p.grad).all()) \
                            or not float(p.grad.abs().max()) > 0:
                        fail(f'{name}.{k}: gradient missing, non-finite or zero')
            n_params = sum(1 for net in trainer.nets.values() for _ in net.parameters())
            print(f'train slice: every one of {n_params} parameters of both nets has a '
                  'finite, non-zero gradient after micro-step 1')
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or opt.updates != TRAIN_UPDATES or trainer.bad_step.item() != -1:
        fail(f'train slice: losses {losses}, updates {opt.updates}, bad_step {trainer.bad_step}')
    print(f'train slice: KBR step, ConvNeXt-B + ConvNeXt-T, B={TRAIN_B}, 384x640, accumulate '
          f'{opt.accumulate}, {opt.updates} updates: losses {[round(v, 5) for v in losses]}; '
          f'launches per micro-step {TRAIN_LAUNCHES}; peak device memory '
          f'{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)')

    plain = _build_trainer(False, weights)[2]
    samples = {'kernel': [], 'plain': []}
    for name in ('plain', 'kernel', 'kernel', 'plain'):
        _time_steps(step if name == 'kernel' else plain, x, y, gen, 1)  # warm
        samples[name] += _time_steps(step if name == 'kernel' else plain, x, y, gen)
    for name, ts in samples.items():
        med = float(np.median(ts))
        print(f'train micro-step {name:6s}: median {med:.2f} ms (min {min(ts):.2f}, max '
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


class RunLog:
    """Scalar writer for `MonoDepthLoop` at `log_every_n_steps: 1`: per training
    micro-step its loss and bucket shape as the loop logs them, and the time the
    loop's own `Step` timer gained since the step before."""

    def __init__(self):
        self.loop, self.rows, self._seen = None, {}, 0.0

    def add_scalar(self, tag: str, val: float, step: int) -> None:
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
              n_batches: int = RUN_BATCHES):
    """One `MonoDepthLoop.fit()` over `SceneLoader`s -> (loop, stats): the launch
    counts of the fit, each micro-step's (bucket, ms, loss) and the wall time."""
    from slowtv_monodepth_tpu_torch.core import MonoDepthLoop
    log = RunLog()
    loop = log.loop = MonoDepthLoop(
        cfg, ckpt_dir, writer=log,
        train_dl=SceneLoader(scenes, n_batches, RUN_SRC_SHAPE, seed=RUN_SEED),
        val_dl=SceneLoader(scenes, 1, (384, 640), seed=RUN_SEED + 1) if val else None)
    loop.sync_timers = True  # each stage of the epoch waits for the device: a true split
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
             'split': loop.timer.total_elapsed()}
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


def _expected_run_counts(n: int, v: int, warp_bf16: bool = False) -> dict:
    """Launches of `n` training micro-steps on 720x1280 sources (every batch is
    resampled, 4 tensors each: x and y, imgs and supp_imgs) and `v` validation steps."""
    step_warp = {'warp_packed' if warp_bf16 else 'warp': n + v}
    counts = {'dwconv': 108 * n + 54 * v, 'decoder_stage': 2 * (n + v), 'decoder_stage_bwd': 2 * n,
              'dwconv_dw': 54 * n, 'warp': 0, 'warp_packed': 0, 'photo_fwd': 2 * (n + v),
              'photo_bwd': n, 'convnext_block': 0}
    counts.update(step_warp)
    counts['warp'] += 4 * n
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


def profile_train(out: Path = ROOT / 'build' / 'train_profile.txt',
                  matmul: str = 'highest') -> None:
    """Where the KBR micro-step's device time goes (not part of `main`).

    `python3 -c 'import chip_smoke; chip_smoke.profile_train()'` times 5 warm
    micro-steps of the kernel path, runs 2 more under `torch.profiler`, and
    writes the device time per kernel and per category to `out` (a path
    relative to the working directory, or under `build/` by default).
    `matmul` is `torch.set_float32_matmul_precision`'s argument: 'highest'
    (exact float32, the numerics of `main`) or 'high' (TF32 matmuls, the KBR
    recipe's `trainer.matmul`).
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
    step = _build_trainer(True, weights)[2]
    for _ in range(3):
        step(x, y, gen)['loss'].item()
    wall = float(np.median(_time_steps(step, x, y, gen)))  # without the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(x, y, gen)['loss'].item()
    rows = [(e.key, e.self_device_time_total / 1e3 / 2, e.count // 2)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False) and not e.key.startswith('Optimizer.')]
    rows.sort(key=lambda r: -r[1])
    device = sum(r[1] for r in rows)
    cats = {'hand-written kernels': ('dwconv_', 'warp_bilinear', 'photo_', 'conv3x3_reflect',
                                     'sigmoid_grad', 'reduce_weight_grad'),
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
    lines = [f"KBR micro-step, kernel path, B={TRAIN_B}, 384x640, float32 matmul '{matmul}': wall "
             f'{wall:.2f} ms (median of 5, no profiler), device {device:.2f} ms in '
             f'{sum(r[2] for r in rows)} kernel launches (under the profiler) per micro-step: '
             f'idle {100 * (1 - device / wall):.1f}%']
    lines += [f'{c:28s} {ms:9.3f} ms {100 * ms / device:5.1f}%' for c, ms in
              sorted(totals.items(), key=lambda kv: -kv[1])]
    lines += ['', 'kernel (self device time per micro-step, launches per micro-step):']
    lines += [f'{ms:9.3f} ms {n:6d}  {name[:150]}' for name, ms, n in rows[:60]]
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text('\n'.join(lines) + '\n')
    print('\n'.join(lines[:30]))


def main() -> None:
    t0 = time.perf_counter()
    phase_device()
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
    run_launches = phase_run(scenes)
    sources = {'dwconv': ('dwconv.cu', 'pallas_dwconv.py:59'),
               'decoder_stage': ('decoder_stage.cu', 'pallas_decoder.py:249'),
               'decoder_stage_bwd': ('decoder_stage_bwd.cu', 'pallas_decoder.py:268'),
               'dwconv_dw': ('dwconv.cu', 'pallas_dwconv.py:75'),
               'warp': ('warp.cu', 'pallas_warp.py:130'),
               'warp_packed': ('warp.cu', 'pallas_warp.py:225'),
               'photo_fwd': ('photo.cu', 'pallas_photo.py:116'),
               'photo_bwd': ('photo.cu', 'pallas_photo.py:159'),
               'convnext_block': ('convnext_block.cu', 'pallas_convnext.py:147')}
    # Launches: the serving slice's for kernels 1 and 3, its fused-blocks half
    # for 9, the training slice's for 2, 5, 7, 8, the training run's for 4 and 6.
    counts = {**train_launches, **launches,
              **{k: run_launches[k] for k in ('decoder_stage_bwd', 'warp_packed')}}
    if not all(counts[name] > 0 and (run_launches[name] > 0 or name == 'convnext_block')
               for name in sources):  # training runs with the blocks unfused
        fail(f'a kernel was never launched on its main path: {counts}, run {run_launches}')
    line = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': f'slowtv_monodepth_tpu_torch/csrc/{src}',
         'replaces': f'slowtv_monodepth_tpu/ops/{rep}', 'launches': counts[name],
         'max_abs_err': kern[name]['err'], 'ms': kern[name]['ms'],
         'plain_ms': kern[name]['plain_ms'], 'bound_ms': kern[name]['bound_ms'],
         'bound_by': ('bytes' if kern[name]['bound_bytes_ms'] >= kern[name]['bound_ops_ms']
                      else 'operations'),
         'library_ms': kern[name]['library_ms']}
        for name, (src, rep) in sources.items()]}
    print('(launches: dwconv and decoder_stage in the serving slice, convnext_block in its '
          "fused-blocks half, decoder_stage_bwd in the training run's first epoch, warp_packed in "
          'its bf16 epoch, the others in the training slice; ms / plain_ms / bound_ms / library_ms: '
          'device time per ConvNeXt-B + decoder forward at B=2, 384x640, for dwconv and '
          'decoder_stage, per request (36 blocks at B=1, 384x640) for convnext_block, per KBR '
          'micro-step at B=4, 384x640 for the others; convnext_block max_abs_err is relative to '
          'max|y|; bound_ms from 67 TFLOP/s float32 and 3.35 TB/s; photo_bwd and '
          "decoder_stage_bwd max_abs_err are relative to the gradient's own largest magnitude; total run "
          f'{time.perf_counter() - t0:.0f} s)')
    print(json.dumps(line))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
