#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU (H100).

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
The last two lines are a JSON object per kernel and the contract line
`{"ok": true, "device": {...}}`.

Usage: python3 chip_smoke.py   (from the repo root, one CUDA card)
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
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
CONVNEXT_B_BLOCKS = (3, 3, 27, 3)
# Tolerances (float32 on both sides, sums taken in another order):
DWCONV_ATOL = 1e-5   # 49-tap sums of O(1) values (measured ~1.4e-6)
STAGE_ATOL = 1e-5    # 9*ci-term sums (ci <= 64) through ELU, sigmoid (~2.5e-6)
GOLDEN_ATOL = 1e-5   # 36 blocks + decoder vs the JAX package on the CPU (~8e-7)


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


def phase_slice(sd) -> dict:
    from slowtv_monodepth_tpu_torch.core import BenchmarkPredictor, save_checkpoint
    from slowtv_monodepth_tpu_torch.ops import depthwise_conv, fused_upconv_stage
    from slowtv_monodepth_tpu_torch.quickstart import predict, save_disp

    scenes = _make_scenes()
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


def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    kern = phase_kernels()
    sd = phase_golden()
    launches = phase_slice(sd)
    line = {'kernels': [
        {'name': 'dwconv', 'route': 'cuda',
         'source': 'slowtv_monodepth_tpu_torch/csrc/dwconv.cu',
         'replaces': 'slowtv_monodepth_tpu/ops/pallas_dwconv.py:59',
         'launches': launches['dwconv'], 'max_abs_err': kern['dwconv']['err'],
         'ms': kern['dwconv']['ms'], 'plain_ms': kern['dwconv']['plain_ms']},
        {'name': 'decoder_stage', 'route': 'cuda',
         'source': 'slowtv_monodepth_tpu_torch/csrc/decoder_stage.cu',
         'replaces': 'slowtv_monodepth_tpu/ops/pallas_decoder.py:249',
         'launches': launches['decoder_stage'],
         'max_abs_err': kern['decoder_stage']['err'],
         'ms': kern['decoder_stage']['ms'], 'plain_ms': kern['decoder_stage']['plain_ms']},
    ]}
    print(f'(kernel ms / plain_ms: device time per ConvNeXt-B + decoder forward at B=2, '
          f'384x640; total run {time.perf_counter() - t0:.0f} s)')
    print(json.dumps(line))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
