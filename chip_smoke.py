#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and KBR training step on one NVIDIA GPU (H100).

Phases, in order; any failure exits non-zero and prints no result:
1. device: require CUDA, print the card's name and power limit, pin exact
   float32 numerics (no TF32 in cuDNN convs or matmuls).
2. build: compile the port's CUDA kernels from `slowtv_monodepth_tpu_torch/csrc`.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the serving path's shapes (B=2) and ragged shapes; times both.
4. golden: ConvNeXt-B + monodepth at full width with seeded weights
   (`models.seeded_state_dict`) against the JAX package's outputs stored in
   `tests/fixtures/torch_port_golden.npz`.
5. slice: a reference-layout checkpoint of those weights with the KBR
   `net.depth` cfg -> `BenchmarkPredictor.load_model` -> `quickstart.predict`
   on 6 synthetic 384x640 scenes -> .npy files; asserts the outputs and the
   launch counts (36 dwconv + 2 decoder stages per request), then times warm
   requests at B=1 and B=4 on the kernel path and on the plain path.
6. training kernels: the tap gradient (kernel 2), the warp (5) and the
   photometric error forward and backward (7, 8) against their plain
   versions (in float64) at the training step's shapes (B=4, 384x640) and
   ragged shapes; times kernel and plain (float32).
7. training golden: one KBR micro-step at full width (ConvNeXt-B + ConvNeXt-T,
   B=2, 64x96) against the JAX package's loss, gradients and loss after one
   update, stored in `tests/fixtures/torch_train_golden.npz`
   (`slowtv_monodepth_tpu_torch/train_golden.py`).
8. training slice: `MonoDepthTrainer(cfg)` -> `parsers.make_optimizer(cfg,
   nets, steps_per_epoch, accumulate=2)` -> `make_step_fn` on the KBR cfg at
   full width, B=4, 384x640 (synthetic scenes, supports shifted by +-2 px, a
   fixed K), 3 optimizer updates; asserts a finite loss, a finite non-zero
   gradient for every parameter of both nets and the launch counts of every
   micro-step (warp 1, photo_fwd 2, photo_bwd 1, dwconv 108, dwconv_dw 54,
   decoder_stage 0), then times micro-steps on the kernel path and on the
   plain path (`kernels=False`) and reads the peak device memory.
9. train -> serve: the trained weights -> `core.save_checkpoint` ->
   `BenchmarkPredictor.load_model` -> one `quickstart.predict` request.
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
# and an input-gradient dwconv launch and a tap gradient, no fused stage.
TRAIN_LAUNCHES = {'dwconv': 108, 'decoder_stage': 0, 'dwconv_dw': 54, 'warp': 1,
                  'photo_fwd': 2, 'photo_bwd': 1}
CONVNEXT_B_BLOCKS = (3, 3, 27, 3)
# Tolerances (float32 on both sides, sums taken in another order):
DWCONV_ATOL = 1e-5   # 49-tap sums of O(1) values (measured ~1.4e-6)
STAGE_ATOL = 1e-5    # 9*ci-term sums (ci <= 64) through ELU, sigmoid (~2.5e-6)
GOLDEN_ATOL = 1e-5   # 36 blocks + decoder vs the JAX package on the CPU (~8e-7)
# Against the plain version in float64:
DW_ATOL = 1e-5       # tap gradient, normalized to O(1) taps; sums over b*h*w terms
WARP_ATOL = 1e-5     # 4-corner bilinear of values in [0, 1]
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
    for line in b.log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
            print(f'  {line.strip()}')


def _rand(rs, *shape, scale=1.0):
    return torch.from_numpy((scale * rs.standard_normal(shape)).astype(np.float32)).cuda()


def phase_kernels() -> dict:
    from slowtv_monodepth_tpu_torch.ops import (depthwise_conv, depthwise_conv_plain,
                                                fused_upconv_stage, fused_upconv_stage_plain)
    rs = np.random.RandomState(0)
    res = {'dwconv': {'err': 0.0, 'ms': 0.0, 'plain_ms': 0.0},
           'decoder_stage': {'err': 0.0, 'ms': 0.0, 'plain_ms': 0.0}}

    # (b, h, w, c, k, blocks per ConvNeXt-B forward): the four stage shapes
    # at B=2 (timed), at B=1 (a quickstart request), then ragged ones.
    dw_cases = [(2, 96, 160, 128, 7, 3), (2, 48, 80, 256, 7, 3),
                (2, 24, 40, 512, 7, 27), (2, 12, 20, 1024, 7, 3),
                (1, 96, 160, 128, 7, 0), (1, 48, 80, 256, 7, 0),
                (1, 24, 40, 512, 7, 0), (1, 12, 20, 1024, 7, 0),
                (2, 37, 53, 70, 7, 0), (1, 9, 13, 45, 1, 0), (1, 9, 13, 45, 3, 0),
                (1, 9, 13, 45, 5, 0), (1, 9, 13, 45, 9, 0)]
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
            res['dwconv']['ms'] += n * ms
            res['dwconv']['plain_ms'] += n * pms
            line += f'; kernel {ms:.4f} ms, plain (cuDNN) {pms:.4f} ms, x{n} per forward'
        print(line)
        if not err <= DWCONV_ATOL:
            fail(line)

    # (b, h, w, ci, cd, stages per forward): KBR stages 1 and 0 at B=2
    # (timed) and B=1, then ragged ones.
    st_cases = [(2, 96, 160, 64, 32, 1), (2, 192, 320, 32, 16, 1),
                (1, 96, 160, 64, 32, 0), (1, 192, 320, 32, 16, 0),
                (2, 23, 37, 6, 5, 0), (1, 21, 19, 20, 20, 0)]
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
            res['decoder_stage']['ms'] += n * ms
            res['decoder_stage']['plain_ms'] += n * pms
            line += f'; kernel {ms:.4f} ms, plain (cuDNN) {pms:.4f} ms'
        print(line)
        if not err <= STAGE_ATOL:
            fail(line)
    torch.cuda.synchronize()
    return res


def _seeded_net(seed: int, kernels: bool, sd=None):
    from slowtv_monodepth_tpu_torch.models import DepthNet, seeded_state_dict
    if sd is None:
        with torch.device('meta'):
            meta = DepthNet(**KBR_DEPTH_CFG)
        sd = {k: torch.from_numpy(v) for k, v in seeded_state_dict(meta, seed).items()}
    net = DepthNet(**KBR_DEPTH_CFG, kernels=kernels)
    net.load_state_dict(sd)
    return net.cuda().eval(), sd


def phase_golden():
    with np.load(GOLDEN) as f:
        gold = {k: f[k] for k in f.files}
    net, sd = _seeded_net(int(gold['seed']), kernels=True)
    x = torch.from_numpy(gold['x']).cuda().permute(0, 3, 1, 2)
    with torch.no_grad():
        disp = net(x)['disp']
    for s in range(4):
        got = disp[s].permute(0, 2, 3, 1).cpu().numpy()
        want = gold[f'disp_{s}']
        if got.shape != want.shape:
            fail(f'golden disp {s}: shape {got.shape} vs {want.shape}')
        err = float(np.abs(got - want).max())
        print(f'golden ConvNeXt-B disp[{s}] {got.shape}: max|port-JAX| {err:.2e} '
              f'(tol {GOLDEN_ATOL:.0e})')
        if not err <= GOLDEN_ATOL:
            fail(f'golden disp {s} off by {err}')
    return sd


def _make_scenes() -> list[np.ndarray]:
    spec = importlib.util.spec_from_file_location('demo_generate', ROOT / 'assets' / 'generate.py')
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return [gen.make_scene(kind, seed=s).astype(np.float32) / 255.0
            for kind in gen.PALETTES for s in (1, 2)]


def _time_requests(net, imgs: np.ndarray, n: int = 10) -> list[float]:
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
    from slowtv_monodepth_tpu_torch.ops import depthwise_conv, fused_upconv_stage
    from slowtv_monodepth_tpu_torch.quickstart import predict, save_disp

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = {'net': {'depth': KBR_DEPTH_CFG}, 'trainer': KBR_TRAINER_CFG}
        save_checkpoint(tmp / 'kbr_seeded.ckpt', {'depth': sd}, cfg)
        net = BenchmarkPredictor('cuda').load_model(tmp / 'kbr_seeded.ckpt')

        depthwise_conv.launches = fused_upconv_stage.launches = 0
        for i, img in enumerate(scenes):
            save_disp(predict(net, img), f'request_{i}', tmp, ['.npy'])
        torch.cuda.synchronize()
        launches = {'dwconv': depthwise_conv.launches,
                    'decoder_stage': fused_upconv_stage.launches}
        outs = [np.load(tmp / f'request_{i}.npy') for i in range(len(scenes))]

    print(f'slice: {len(scenes)} requests, launches {launches}')
    for i, d in enumerate(outs):
        ok = (d.shape == scenes[i].shape[:2] and np.isfinite(d).all()
              and 0 < d.min() and d.max() < 1 and d.std() > 1e-4)
        print(f'  request {i}: disp {d.shape} range [{d.min():.4f}, {d.max():.4f}] '
              f'std {d.std():.4f} {"ok" if ok else "BAD"}')
        if not ok:
            fail(f'request {i} output is not a finite, non-constant (0, 1) map')
    want = {'dwconv': sum(CONVNEXT_B_BLOCKS) * len(scenes), 'decoder_stage': 2 * len(scenes)}
    if launches != want:
        fail(f'launch counts {launches}, expected {want}')

    plain, _ = _seeded_net(0, kernels=False, sd=sd)
    lat = {}
    for b in (1, 4):
        imgs = np.stack([scenes[i % len(scenes)] for i in range(b)])
        samples = {'kernel': [], 'plain': []}
        for name in ('plain', 'kernel', 'kernel', 'plain'):
            samples[name] += _time_requests(net if name == 'kernel' else plain, imgs)
        for name, ts in samples.items():
            med = float(np.median(ts))
            lat[(b, name)] = med
            print(f'serving B={b} {name:6s}: median {med:.2f} ms/request '
                  f'(min {min(ts):.2f}, max {max(ts):.2f}, n={len(ts)}), '
                  f'{1e3 * b / med:.1f} images/s')
    return launches


# ------------------------------------------------------------- training path
def _counters() -> dict:
    """Kernel name -> its wrapper, which carries the `launches` count."""
    from slowtv_monodepth_tpu_torch.ops import decoder_stage, dwconv, photo, sample
    return {'dwconv': dwconv.depthwise_conv, 'decoder_stage': decoder_stage.fused_upconv_stage,
            'dwconv_dw': dwconv.dwconv_dw, 'warp': sample.warp_bilinear,
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
    from slowtv_monodepth_tpu_torch.ops import dwconv, photo, sample
    rs = np.random.RandomState(1)
    res = {k: {'err': 0.0, 'ms': 0.0, 'plain_ms': 0.0}
           for k in ('dwconv_dw', 'warp', 'photo_fwd', 'photo_bwd')}

    def record(name, err, tol, line, n=0, fn=None, plain=None):
        res[name]['err'] = max(res[name]['err'], err)
        line += f': max|kernel-plain(f64)| {err:.2e} (tol {tol:.1e})'
        if n:
            ms, pms = cuda_ms(fn, iters=10), cuda_ms(plain, iters=10)
            res[name]['ms'] += n * ms
            res[name]['plain_ms'] += n * pms
            line += f'; kernel {ms:.4f} ms, plain {pms:.4f} ms, x{n} per micro-step'
        print(line)
        if not err <= tol:
            fail(line)

    # Tap gradient at the step's block shapes: ConvNeXt-B at B=4, ConvNeXt-T
    # on the 2 x 4 pose pairs, then ragged ones; taps normalized to O(1).
    dw_cases = [(4, 96, 160, 128, 7, 3), (4, 48, 80, 256, 7, 3), (4, 24, 40, 512, 7, 27),
                (4, 12, 20, 1024, 7, 3), (8, 96, 160, 96, 7, 3), (8, 48, 80, 192, 7, 3),
                (8, 24, 40, 384, 7, 9), (8, 12, 20, 768, 7, 3),
                (2, 37, 53, 70, 7, 0), (1, 9, 13, 45, 3, 0), (1, 9, 13, 45, 9, 0)]
    for b, h, w, c, k, n in dw_cases:
        x = _rand(rs, b, h, w, c)
        g = _rand(rs, b, h, w, c, scale=1 / np.sqrt(b * h * w))
        err = _max_err(dwconv.dwconv_dw(x, g, k), dwconv.dwconv_dw_plain(x.double(), g.double(), k))
        record('dwconv_dw', err, DW_ATOL, f'dwconv_dw {(b, h, w, c)} k={k}', n,
               lambda: dwconv.dwconv_dw(x, g, k), lambda: dwconv.dwconv_dw_plain(x, g, k))

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
    for im, cx, cy, n in cases:
        got = sample.warp_bilinear(im, cx, cy)
        want = sample.warp_bilinear_plain(im.double(), cx.double(), cy.double())
        record('warp', max(_max_err(a, b) for a, b in zip(got, want)), WARP_ATOL,
               f'warp {tuple(im.shape)} -> {tuple(cx.shape[1:])}', n,
               lambda: sample.warp_bilinear(im, cx, cy),
               lambda: sample.warp_bilinear_plain(im, cx, cy))

    # Photometric error: the warped stack (m=32) and the static stack (m=8)
    # forward, the warped stack backward; then ragged shapes with exact ties.
    for mm, n_fwd, n_bwd in [(m, 1, 1), (2 * TRAIN_B, 1, 0)]:
        x, y = _scene_pair(scenes, mm, rs)
        g = torch.from_numpy(rs.rand(mm, 384, 640).astype(np.float32)).cuda()
        _photo_case(record, x, y, g, n_fwd, n_bwd)
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
    record('photo_fwd', _max_err(photo.photo_fwd(x, y, 0.85), want),
           PHOTO_ATOL + 2 * plain32, f'photo_fwd {tuple(x.shape)} (plain f32 {plain32:.2e})',
           n_fwd, lambda: photo.photo_fwd(x, y, 0.85), lambda: photo.photo_fwd_plain(x, y, 0.85))
    want = photo.photo_bwd_plain(xd, yd, g.double(), 0.85)
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    plain32 = max(_max_err(a, b) for a, b in zip(photo.photo_bwd_plain(x, y, g, 0.85), want))
    err = max(_max_err(a, b) for a, b in zip(photo.photo_bwd(x, y, g, 0.85), want))
    record('photo_bwd', err / scale, PHOTO_BWD_RTOL + 2 * plain32 / scale,
           f'photo_bwd {tuple(x.shape)} (relative to max|grad| {scale:.3g}; plain f32 '
           f'{plain32 / scale:.2e})', n_bwd,
           lambda: photo.photo_bwd(x, y, g, 0.85), lambda: photo.photo_bwd_plain(x, y, g, 0.85))


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
        meta = parsers.get_net(KBR_TRAIN_CFG['net'], fused_stages=False)
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


def profile_train(out: Path = ROOT / 'build' / 'train_profile.txt') -> None:
    """Where the KBR micro-step's device time goes (not part of `main`).

    `python3 -c 'import chip_smoke; chip_smoke.profile_train()'` times 5 warm
    micro-steps of the kernel path, runs 2 more under `torch.profiler`, and
    writes the device time per kernel and per category to `out` (a path
    relative to the working directory, or under `build/` by default).
    """
    out = Path(out)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from slowtv_monodepth_tpu_torch import parsers
    from slowtv_monodepth_tpu_torch.models import seeded_state_dict
    phase_device()
    with torch.device('meta'):
        meta = parsers.get_net(KBR_TRAIN_CFG['net'], fused_stages=False)
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
    cats = {'hand-written kernels': ('dwconv_', 'warp_bilinear', 'photo_'),
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
    lines = [f'KBR micro-step, kernel path, B={TRAIN_B}, 384x640, exact float32: wall '
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
    sources = {'dwconv': ('dwconv.cu', 'pallas_dwconv.py:59'),
               'decoder_stage': ('decoder_stage.cu', 'pallas_decoder.py:249'),
               'dwconv_dw': ('dwconv.cu', 'pallas_dwconv.py:75'),
               'warp': ('warp.cu', 'pallas_warp.py:130'),
               'photo_fwd': ('photo.cu', 'pallas_photo.py:116'),
               'photo_bwd': ('photo.cu', 'pallas_photo.py:159')}
    line = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': f'slowtv_monodepth_tpu_torch/csrc/{src}',
         'replaces': f'slowtv_monodepth_tpu/ops/{rep}',
         'launches': (launches if name in launches else train_launches)[name],
         'max_abs_err': kern[name]['err'], 'ms': kern[name]['ms'],
         'plain_ms': kern[name]['plain_ms']}
        for name, (src, rep) in sources.items()]}
    print('(launches: dwconv and decoder_stage in the serving slice, the others in the training '
          'slice; ms / plain_ms: device time per ConvNeXt-B + decoder forward at B=2, 384x640, '
          'for dwconv and decoder_stage, per KBR micro-step at B=4, 384x640 for the others; '
          f'photo_bwd max_abs_err is relative to the largest gradient; total run '
          f'{time.perf_counter() - t0:.0f} s)')
    print(json.dumps(line))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
