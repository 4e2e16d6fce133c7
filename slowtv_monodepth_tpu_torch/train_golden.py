"""The KBR training golden: its configuration, the port's micro-step on it, and the check.

`tests/fixtures/torch_train_golden.npz` holds one KBR micro-step of the JAX
package at full width (ConvNeXt-B + monodepth depth net, ConvNeXt-T pose
net with learned intrinsics, the KBR losses and optimizer) at a small
spatial size (B=2, 64x96):
- the inputs: images (supports are them shifted by +-2 px, K is fixed, as
  in `make_batch`) and the automask tie-break noise JAX drew;
- the loss and its parts;
- the norm of every parameter's gradient (port key order) and a few whole
  gradients: a depthwise conv's taps (kernel 2's output), a layer scale,
  the pose and intrinsics heads' outputs, the finest disparity head;
- the loss on the same batch after one AdamW update (accumulate 1,
  steps_per_epoch 1: lr 1e-5).
Weights: `models.seeded_state_dict(seed)` of the port's nets, carried into
JAX by `convert_reference_ckpt`. `tests/test_torch_train_golden.py` checks
that the port reproduces it on the CPU (plain versions) and writes it anew;
`chip_smoke.py` checks the kernels on the card against it.

Tolerances (float32, 36 + 18 residual blocks, sums in another order): loss
rtol 1e-5; gradient norms rtol 1e-3; whole gradients atol 1e-3 of their
largest magnitude.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ['FIXTURE', 'SEED', 'B', 'H', 'W', 'SUPP', 'CFG', 'WHOLE', 'LOSS_RTOL', 'NORM_RTOL',
           'GRAD_RTOL', 'load_fixture', 'make_batch', 'seeded_weights', 'port_step', 'compare']

FIXTURE = Path(__file__).resolve().parents[1] / 'tests' / 'fixtures' / 'torch_train_golden.npz'
SEED = 0
B, H, W = 2, 64, 96
SUPP = (-1, 1)
CFG = {
    'net': {'depth': {'enc_name': 'convnext_base', 'pretrained': False, 'dec_name': 'monodepth',
                      'out_scales': [0, 1, 2, 3]},
            'pose': {'enc_name': 'convnext_tiny', 'pretrained': False, 'learn_K': True}},
    'loss': {'img_recon': {'weight': 1, 'use_min': True, 'use_automask': True},
             'disp_smooth': {'weight': 0.001, 'use_edges': True}},
    'optimizer': {'type': 'adamw', 'lr': 1e-4, 'weight_decay': 1e-3},
    'scheduler': {'steplr': {'step_size': 40, 'gamma': 0.1},
                  'linear': {'start_factor': 0.1, 'total_iters': 4}},
    'trainer': {'min_depth': 0.1, 'max_depth': 100, 'always_fwd_pose': False},
}
WHOLE = ('depth.encoder.stages.0.blocks.0.conv_dw.weight',
         'depth.encoder.stages.2.blocks.26.gamma',
         'depth.decoders.disp.decoder.10.weight',
         'pose.decoders.pose.2.bias', 'pose.decoders.focal.2.weight',
         'pose.decoders.offset.2.weight')
LOSS_RTOL, NORM_RTOL, GRAD_RTOL = 1e-5, 1e-3, 1e-3


def load_fixture(path: Path = FIXTURE) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def make_batch(imgs: np.ndarray) -> tuple[dict, dict]:
    supp = np.stack([np.roll(imgs, 2, axis=2), np.roll(imgs, -2, axis=2)])
    b, h, w = imgs.shape[:3]
    K = np.array([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    x = {'imgs': imgs, 'supp_imgs': supp}
    return x, dict(x, K=np.ascontiguousarray(np.broadcast_to(K, (b, 4, 4))))


def seeded_weights(seed: int = SEED) -> dict:
    """Port-keyed numpy weights {'depth': sd, 'pose': sd} (meta nets: no compute)."""
    from . import parsers
    from .models import seeded_state_dict
    with torch.device('meta'):
        nets = parsers.get_net(CFG['net'])
    return {k: seeded_state_dict(net, seed) for k, net in nets.items()}


def port_step(gold: dict, device: str, kernels: bool = True, fused_blocks: bool = False) -> dict:
    """One micro-step of the port's trainer on `device` ('cuda', or 'cpu' as
    the tests ask) on the fixture's inputs -> results
    in the fixture's keys (numpy), plus `grad_finite_nonzero`. `fused_blocks`
    turns the fused ConvNeXt blocks on in both nets (the same weights)."""
    from . import parsers
    from .core.trainer import MonoDepthTrainer
    cfg = {**CFG, 'net': {k: {**v, 'fused_blocks': fused_blocks} for k, v in CFG['net'].items()}}
    trainer = MonoDepthTrainer(cfg, kernels=kernels)
    for name, sd in seeded_weights(int(gold['seed'])).items():
        trainer.nets[name].load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    trainer.to(device)
    opt = parsers.make_optimizer(CFG, trainer.nets, steps_per_epoch=1, accumulate=1)
    x, y = (({k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in d.items()})
            for d in make_batch(gold['imgs']))
    noise = torch.from_numpy(gold['noise']).to(device)
    loss, (ld, _) = trainer.loss_fn(x, y, SUPP, noise=noise)
    loss.backward()
    grads = {f'{n}.{k}': p.grad for n, net in trainer.nets.items()
             for k, p in net.named_parameters()}
    out = {'loss': loss.item(), 'loss_img_recon': ld['loss_img_recon'].item(),
           'loss_disp_smooth': ld['loss_disp_smooth'].item(),
           'grad_names': sorted(grads),
           'grad_norms': np.array([grads[k].norm().item() for k in sorted(grads)]),
           'grad_finite_nonzero': all(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)
                                      for g in grads.values())}
    out.update({f'grad:{k}': grads[k].detach().cpu().numpy() for k in WHOLE})
    opt.step()
    with torch.no_grad():
        out['loss_after_update'] = trainer.loss_fn(x, y, SUPP, noise=noise)[0].item()
    return out


def compare(got: dict, gold: dict) -> list[str]:
    """-> the failures, one line each."""
    bad = []
    for k in ('loss', 'loss_img_recon', 'loss_disp_smooth', 'loss_after_update'):
        if not abs(got[k] - float(gold[k])) <= LOSS_RTOL * abs(float(gold[k])):
            bad.append(f'{k}: {got[k]!r} vs {float(gold[k])!r}')
    if list(got['grad_names']) != [str(n) for n in gold['grad_names']]:
        bad.append('gradient names differ')
    else:
        rel = np.abs(got['grad_norms'] - gold['grad_norms']) / np.maximum(gold['grad_norms'], 1e-30)
        if not rel.max() <= NORM_RTOL:
            i = int(rel.argmax())
            bad.append(f'grad norm {gold["grad_names"][i]}: rel err {rel[i]:.3g}')
    for k in WHOLE:
        want = gold[f'grad:{k}']
        err = float(np.abs(got[f'grad:{k}'] - want).max())
        if not err <= GRAD_RTOL * float(np.abs(want).max()):
            bad.append(f'grad {k}: max abs err {err:.3g} (max |g| {np.abs(want).max():.3g})')
    return bad
