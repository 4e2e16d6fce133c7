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
   widened source. Kernel 1 at the step's eight block shapes (float64,
   timed per micro-step); kernels 2 (at the step's eight block shapes) and
   4 called twice on the same inputs must give the same bits. The fused block's backward (kernel 10, with kernels 1 and 2
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
Every time is a device time (`cuda_ms`: the calls captured into one CUDA
graph, CUDA events around one replay) with the eager time beside it. The last
two lines are a JSON object per kernel and the contract line
`{"ok": true, "device": {...}}`.

Usage: python3 chip_smoke.py   (from the repo root, one CUDA card)
"""
from __future__ import annotations

import contextlib
import importlib.util
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
WARP_ATOL = 1e-5     # 4-corner bilinear of values in [0, 1]
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
    # off the tiles; the training run's buckets at B=4, stages 1 and 0.
    st_cases = [(b, h, w, ci, cd) for b in (2, 4, 1)
                for h, w, ci, cd in ((96, 160, 64, 32), (192, 320, 32, 16))]
    st_cases += [(2, 23, 37, 6, 5), (1, 21, 19, 20, 20), (1, 2, 3, 4, 3), (2, 3, 2, 3, 1),
                 (1, 37, 45, 40, 17)]
    for _, (bh, bw) in run_buckets():
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
    err = max(_max_err(a, b) for a, b in zip(photo.photo_bwd(x, y, g, 0.85), want))
    record('photo_bwd', err / scale, PHOTO_BWD_RTOL + 2 * plain32 / scale,
           f'photo_bwd {tuple(x.shape)} (relative to max|grad| {scale:.3g}; plain f32 '
           f'{plain32 / scale:.2e})', n_bwd,
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
              'photo_bwd': n, 'convnext_block': 0, 'convnext_block_bwd': 0}
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
              '5 warp': ('warp_bilinear_kernel',), '6 warp_packed': ('warp_bilinear_packed',),
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
    phase_train_golden(fused_blocks=True)
    fused_launches, _ = phase_train(scenes, fused_blocks=True)
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
