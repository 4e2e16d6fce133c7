"""Port differentials for the recipe families beside KBR: virtual stereo
(Monodepth, MonoResMatch, DVSO), proxy-depth regression with the Depth-Hints
automask (Depth-Hints, Kuznietsov), predicted weighting masks (SfM-Learner,
Klodt) and the smoothness and occlusion ablations of `cfg/abl_smooth/`.

Same numpy inputs (seeded) through the JAX package and the port, float32, the
port on the CPU (its kernels' plain versions). The JAX side runs as its own
tests run it on the CPU: its XLA paths, the automask noise drawn from its key
and handed to the port.
- losses: `RegressionLoss` {l1, log_l1, berhu} x invert x mask, `SmoothReg`
  {laplacian, blur, both}, `OccReg` +-invert, `MaskReg`, `ReconstructionLoss`
  with each mask, with and without the automask, and with 'l2';
- handlers: `image_recon` with masks (the scale-tiled static source),
  `stereo_const`, `depth_regr` with and without the hint automask,
  `disp_occ`, `disp_mask`;
- the trainer without nets: `forward_postprocess` + `forward_loss` on given
  network outputs, with every loss at once, virtual stereo and masks, both
  signs of `T_stereo` in the batch (channel selection, and the stereo view's
  reconstruction taking the same tie-break noise as the main one, as the
  JAX package's takes the same key);
- the trainer with nets: the SfM-Learner and Klodt cfgs as they stand
  (`cfg/benchmark/default.yaml` + the family's file), cut to test size:
  convnext_atto depth and pose nets (the pose net is ResNet-18 in the cfg;
  `tests/test_torch_resnet_trajectory.py` trains that one), 2 scales, B=2, 64x96. DVSO and Depth-Hints are held the same
  way on the first micro-step of `tests/test_torch_families_trajectory.py`;
- every cfg of `cfg/benchmark/`, `cfg/benchmark_ours/` and `cfg/abl_smooth/`
  builds or raises naming its ROADMAP item, as it stands and with the pose
  encoder overlaid to convnext_tiny; every cfg of `cfg/abl_pretrained/` and
  `cfg/abl_bb/` builds as it stands or raises naming A10, and each ResNet or
  ResNeXt one runs one CPU micro-step at a cut size;
- `MonoDepthLoop` on `default.yaml` + `dvso.yaml` over a synthetic KITTI pack.

Tolerances: loss values rtol 1e-5 (float32 sums in another order); the
gradients of a loss or handler atol 1e-4 of the largest JAX magnitude (the
chain runs through the warp and the SSIM ratio; measured <= 2e-6); the
trainer's, per tensor, 1e-3 of the tensor's largest JAX magnitude plus 1e-7,
as `tests/test_torch_train_step.py`. The hint automask is a binary gate with
no tie-break: its bits must agree exactly here (the compared photometric
errors agree to ~1e-7 and no margin on these inputs is that small).
Every differential has a fault that must fail it.
"""
import functools
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu import losses as jlosses
from slowtv_monodepth_tpu import ops as jops
from slowtv_monodepth_tpu.core import handlers as jh
from slowtv_monodepth_tpu.core.trainer import MonoDepthTrainer as JaxTrainer
from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
from slowtv_monodepth_tpu_torch import losses as tlosses
from slowtv_monodepth_tpu_torch import ops as tops
from slowtv_monodepth_tpu_torch import parsers, paths
from slowtv_monodepth_tpu_torch.config import load_merge_yaml
from slowtv_monodepth_tpu_torch.core import HeavyLogger
from slowtv_monodepth_tpu_torch.core import handlers as th
from slowtv_monodepth_tpu_torch.core.trainer import MonoDepthTrainer
from slowtv_monodepth_tpu_torch.models import (autoencoder_state_dict_from_jax,
                                               depth_state_dict_from_jax,
                                               pose_state_dict_from_jax, seeded_state_dict)
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

CFG = Path(__file__).resolve().parents[1] / 'cfg'
B, H, W = 2, 64, 96
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-4      # of the largest JAX magnitude, for losses and handlers
NET_GRAD_RTOL, NET_GRAD_ATOL = 1e-3, 1e-7   # per tensor, for the trainer with nets
GATE_MARGIN, GATE_SHARE = 1e-5, 1e-3  # a binary gate's flips: near a tie, and few


# ------------------------------------------------------------------ helpers
def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol_rel=GRAD_ATOL, what='', outliers=0.0):
    """Within atol_rel of want's largest magnitude; with `outliers`, that share
    of the elements may be off (the pixels where a binary gate flipped)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = atol_rel * max(np.abs(want).max(), 1e-12)
    if outliers:
        off = np.abs(got - want) > atol
        assert off.mean() <= outliers, (what, int(off.sum()), off.size)
        got = np.where(off, want, got)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _grads(jfn, tfn, *arrays):
    """(jax value, jax grads, port value, port grads) of `fn(*arrays)` w.r.t. every
    array. A dict argument {s: array} differentiates each of its entries."""
    jargs = jax.tree.map(jnp.asarray, arrays)
    jv, jg = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(len(arrays)))))(*jargs)
    targs = jax.tree.map(lambda a: _t(a).requires_grad_(), arrays)
    tv = tfn(*targs)
    tv.backward()
    tg = jax.tree.map(lambda t: t.grad.numpy(), targs)
    return float(jv), jax.tree.map(np.asarray, jg), tv.item(), tg


def _assert_same(jv, jg, tv, tg, rtol=LOSS_RTOL, outliers=0.0):
    np.testing.assert_allclose(tv, jv, rtol=rtol)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jg), jax.tree.leaves(tg)):
        _close(got, want, what=str(path), outliers=outliers)


def _K(b=B, h=H, w=W) -> np.ndarray:
    K = np.array([[0.6 * w, 0, 0.5 * w, 0], [0, 0.6 * h, 0.5 * h, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    return np.ascontiguousarray(np.broadcast_to(K, (b, 4, 4)))


def _T_stereo(b=B) -> np.ndarray:
    """KITTI's stereo transform, +-0.1 along x: both signs in the batch."""
    T = np.ascontiguousarray(np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)))
    T[:, 0, 3] = [0.1 if i % 2 == 0 else -0.1 for i in range(b)]
    return T


def _images(rng, b=B, h=H, w=W) -> np.ndarray:
    """Smooth textured images (low-res upsampled + fine noise) in [0, 1), as
    `tests/test_trajectory_parity.py` makes them but never clipped: two equal
    pixels (a tie) take the L1 term's subgradient, which is 0 in the port (as
    the TPU kernel's) and 1 on the JAX package's CPU path."""
    base = rng.random((b, h // 4, w // 4, 3), dtype=np.float32)
    imgs = 0.95 * np.kron(base, np.ones((1, 4, 4, 1), np.float32))
    return (imgs + 0.05 * rng.random((b, h, w, 3), dtype=np.float32)).astype(np.float32)


def _hints(rng, b=B, h=H, w=W) -> np.ndarray:
    """Smooth positive proxy depth in [1, 10] m with ~10% invalid (zero) pixels."""
    d = rng.random((b, h // 8, w // 8, 1), dtype=np.float32)
    d = 1.0 + 9.0 * np.kron(d, np.ones((1, 8, 8, 1), np.float32))
    d[rng.random(d.shape) < 0.1] = 0.0
    return d.astype(np.float32)


def make_batch(supp_idxs, hints: bool, seed: int) -> tuple[dict, dict]:
    """One batch in both packages' layout (numpy, NHWC): supports rolled along
    the width, the stereo frame by +-5 px as its `T_stereo` sign says."""
    rng = np.random.default_rng(seed)
    imgs = _images(rng)
    T = _T_stereo()
    supp = np.stack([np.stack([np.roll(im, 5 if T[j, 0, 3] > 0 else -5, axis=1)
                               for j, im in enumerate(imgs)]) if i == 0
                     else np.roll(imgs, 3 * i, axis=2) for i in supp_idxs])
    x = {'imgs': imgs, 'supp_imgs': np.ascontiguousarray(supp)}
    y = dict(x, K=_K())
    if 0 in supp_idxs:
        y['T_stereo'] = T
    if hints:
        y['depth_hints'] = _hints(rng)
    return x, y


def family_cfg(name: str) -> dict:
    """`cfg/benchmark/default.yaml` + `<name>.yaml` as they stand, cut to test
    size: convnext_atto nets without pretrained weights (for the pose net too:
    the families' losses are what these tests hold; `tests/test_torch_resnet_trajectory.py`
    holds the ResNet-18 pose net), 2 scales."""
    cfg = load_merge_yaml(CFG / 'benchmark' / 'default.yaml', CFG / 'benchmark' / f'{name}.yaml')
    cfg['net']['depth'].update(enc_name='convnext_atto', pretrained=False, out_scales=[0, 1])
    if cfg['net'].get('pose'):
        cfg['net']['pose'].update(enc_name='convnext_atto', pretrained=False)
    return cfg


def supp_of(cfg: dict) -> tuple:
    return tuple(cfg['dataset']['kitti_lmdb']['supp_idxs'])


def seeded_weights(cfg: dict) -> dict:
    """Reference-layout weights from `models.seeded_state_dict`."""
    with torch.device('meta'):
        nets = parsers.get_net(cfg['net'])
    return {f'nets.{k}.{kk}': v for k in nets for kk, v in seeded_state_dict(nets[k], 0).items()}


def port_trainer(cfg: dict, weights: dict) -> MonoDepthTrainer:
    """The port's trainer holding `weights` (built on the meta device: no initial draw,
    every parameter and buffer is loaded)."""
    with torch.device('meta'):
        trainer = MonoDepthTrainer(cfg)
    trainer.nets.to_empty(device='cpu')
    for name, net in trainer.nets.items():
        net.load_state_dict({k[len(name) + 6:]: _t(v) for k, v in weights.items()
                             if k.startswith(f'nets.{name}.')})
    return trainer


def port_layout(tree: dict, cfg: dict) -> dict:
    """JAX {depth, [pose], [autoencoder]} trees -> {'depth.<key>': array, ...} in the port's
    keys."""
    out = {}
    for net, p in tree.items():
        if net == 'depth':
            sd = depth_state_dict_from_jax(p, cfg['net']['depth']['out_scales'])
        elif net == 'pose':
            sd = pose_state_dict_from_jax(p)
        else:
            sd = autoencoder_state_dict_from_jax(p, cfg['net'][net]['out_scales'])
        out.update({f'{net}.{k}': v.numpy() for k, v in sd.items()})
    return out


def jax_noise(cfg: dict, key, shape) -> np.ndarray:
    """The automask noise `JaxTrainer.forward_loss` draws for `img_recon` from
    the loss key (`loss_fn` splits the step key first)."""
    keys = jax.random.split(key, len([k for k, v in cfg['loss'].items() if v is not None]))
    idx = [k for k, v in cfg['loss'].items() if v is not None].index('img_recon')
    return np.asarray(jax.random.normal(keys[idx], shape))


def compare_grads(got: dict, want: dict) -> list:
    """Per tensor, 1e-3 of the tensor's largest JAX magnitude plus 1e-7 -> the failures."""
    assert sorted(got) == sorted(want)
    bad = []
    for k in sorted(want):
        atol = NET_GRAD_RTOL * float(np.abs(want[k]).max()) + NET_GRAD_ATOL
        err = float(np.abs(got[k] - want[k]).max())
        if not err <= atol:
            bad.append(f'{k}: {err:.3g} > {atol:.3g}')
    return bad


# ------------------------------------------------------------- 1. the losses
@pytest.mark.parametrize('mask', [False, True], ids=['no_mask', 'mask'])
@pytest.mark.parametrize('invert', [False, True], ids=['depth', 'invert'])
@pytest.mark.parametrize('name', ['l1', 'log_l1', 'berhu'])
def test_regression_loss_matches_jax(name, invert, mask):
    rng = np.random.default_rng(0)
    pred = (0.5 + 9.5 * rng.random((B, 16, 24, 1))).astype(np.float32)
    target = _hints(rng, h=16, w=24)
    m = (rng.random(target.shape) < 0.7) if mask else None
    jc = jlosses.RegressionLoss(name, invert=invert)
    tc = tlosses.RegressionLoss(name, invert=invert)
    jv, jg, tv, tg = _grads(
        lambda p: jc(p, jnp.asarray(target), None if m is None else jnp.asarray(m))[0],
        lambda p: tc(p, _t(target), None if m is None else _t(m))[0], pred)
    _assert_same(jv, jg, tv, tg)
    _, ld = tc(_t(pred), _t(target), None if m is None else _t(m))
    assert ld['err_regr'].shape == ld['mask_regr'].shape == target.shape


def test_regression_differential_has_teeth(monkeypatch):
    """berHu's dynamic delta taken over the valid pixels only fails: the JAX
    package takes it over every pixel."""
    from slowtv_monodepth_tpu_torch.losses import regression
    rng = np.random.default_rng(0)
    pred = (0.5 + 9.5 * rng.random((B, 16, 24, 1))).astype(np.float32)
    target = _hints(rng, h=16, w=24)
    m = rng.random(target.shape) < 0.7
    m[0, 0, 0, 0] = False
    pred[0, 0, 0, 0] = 100.0  # the largest error, on a masked pixel
    want = float(jlosses.RegressionLoss('berhu')(jnp.asarray(pred), jnp.asarray(target),
                                                 jnp.asarray(m))[0])
    crit = tlosses.RegressionLoss('berhu')
    crit.criterion = lambda p, t: regression.berhu_loss(p * _t(m), t * _t(m))
    got = crit(_t(pred), _t(target), _t(m))[0].item()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


SMOOTH_CASES = {'laplacian': (True, False), 'blur': (False, True), 'laplacian_blur': (True, True)}


@pytest.mark.parametrize('case', sorted(SMOOTH_CASES))
def test_smoothness_matches_jax(case):
    lap, blur = SMOOTH_CASES[case]
    rng = np.random.default_rng(1)
    disp = rng.random((B, 16, 24, 1), dtype=np.float32)
    img = _images(rng, h=16, w=24)
    jc = jlosses.SmoothReg(use_edges=True, use_laplacian=lap, use_blur=blur)
    tc = tlosses.SmoothReg(use_edges=True, use_laplacian=lap, use_blur=blur)
    _assert_same(*_grads(lambda d: jc(d, jnp.asarray(img))[0],
                         lambda d: tc(d, _t(img))[0], disp))
    jld, tld = jc(jnp.asarray(disp), jnp.asarray(img))[1], tc(_t(disp), _t(img))[1]
    for k in ('disp_grad', 'image_grad'):
        _close(tld[k].numpy(), jld[k], 1e-5, k)


@pytest.mark.parametrize('fault', ['blur_repeats_the_edge', 'laplacian_mixed_terms'])
def test_smoothness_differential_has_teeth(monkeypatch, fault):
    """A blur that pads by repeating the edge, or a Laplacian smoothness on the
    mixed terms (dxy, dyx) instead of (dxx, dyy), fails."""
    from slowtv_monodepth_tpu_torch.losses import regularizers
    rng = np.random.default_rng(1)
    disp = rng.random((B, 16, 24, 1), dtype=np.float32)
    img = _images(rng, h=16, w=24)
    lap, blur = (False, True) if fault == 'blur_repeats_the_edge' else (True, False)
    want = float(jlosses.SmoothReg(use_edges=True, use_laplacian=lap, use_blur=blur)(
        jnp.asarray(disp), jnp.asarray(img))[0])
    if fault == 'blur_repeats_the_edge':
        monkeypatch.setattr(regularizers, '_reflect_pad1', lambda x, dim: torch.cat(
            [x.narrow(dim, 0, 1), x, x.narrow(dim, x.shape[dim] - 1, 1)], dim))
    crit = tlosses.SmoothReg(use_edges=True, use_laplacian=lap, use_blur=blur)
    if fault == 'laplacian_mixed_terms':
        crit._fn = lambda x, **kw: regularizers.compute_laplacian(x, **kw)[2:]
    got = crit(_t(disp), _t(img))[0].item()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize('invert', [False, True])
def test_occlusion_matches_jax(invert):
    disp = np.random.default_rng(2).random((B, 8, 12, 1), dtype=np.float32)
    _assert_same(*_grads(lambda d: jlosses.OccReg(invert)(d)[0],
                         lambda d: tlosses.OccReg(invert)(d)[0], disp))


def test_mask_reg_matches_jax_and_has_teeth():
    """BCE(mask, 1) with the mask floored at eps: a mask of exactly 0 (ReLU or
    an underflowed sigmoid) stays finite; without the floor it does not."""
    mask = np.random.default_rng(3).random((B, 8, 12, 2), dtype=np.float32)
    mask[0, 0, 0] = 0.0
    _assert_same(*_grads(lambda m: jlosses.MaskReg()(m)[0], lambda m: tlosses.MaskReg()(m)[0],
                         mask))
    assert not np.isfinite(-torch.log(_t(mask)).mean().item())


RECON_CASES = {  # name -> (loss_name, mask_name, use_min, use_automask)
    'explainability': ('ssim', 'explainability', False, False),
    'explainability_automask': ('ssim', 'explainability', True, True),
    'uncertainty': ('ssim', 'uncertainty', False, False),
    'uncertainty_automask': ('ssim', 'uncertainty', True, True),
    'l2': ('l2', None, False, False),
    'l2_automask': ('l2', None, True, True),
}


def _recon_inputs(rng, n=2, h=16, w=24):
    target = _images(rng, h=h, w=w)
    source = np.stack([np.roll(target, 2 * (i + 1), axis=2) for i in range(n)])
    pred = (source + 0.05 * rng.standard_normal(source.shape)).astype(np.float32)
    mask = rng.random((B, h, w, n), dtype=np.float32)
    return pred, target, source, mask


@pytest.mark.parametrize('case', list(RECON_CASES))
def test_reconstruction_loss_matches_jax(case):
    loss_name, mask_name, use_min, automask = RECON_CASES[case]
    rng = np.random.default_rng(4)
    pred, target, source, mask = _recon_inputs(rng)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (B, 16, 24, 1)))
    kw = dict(loss_name=loss_name, mask_name=mask_name, use_min=use_min, use_automask=automask)
    jc, tc = jlosses.ReconstructionLoss(**kw), tlosses.ReconstructionLoss(**kw)
    args = (pred,) if mask_name is None else (pred, mask)
    _assert_same(*_grads(
        lambda p, m=None: jc(p, jnp.asarray(target), source=jnp.asarray(source), mask=m,
                             rng=key)[0],
        lambda p, m=None: tc(p, _t(target), source=_t(source), mask=m, noise=_t(noise))[0],
        *args))
    if automask:
        jm = jc(jnp.asarray(pred), jnp.asarray(target), source=jnp.asarray(source),
                mask=None if mask_name is None else jnp.asarray(mask), rng=key)[1]['automask']
        tm = tc(_t(pred), _t(target), source=_t(source),
                mask=None if mask_name is None else _t(mask), noise=_t(noise))[1]['automask']
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_reconstruction_differential_has_teeth(monkeypatch):
    """The explainability mask applied after the reduction over views fails."""
    rng = np.random.default_rng(4)
    pred, target, source, mask = _recon_inputs(rng)
    want = float(jlosses.ReconstructionLoss(mask_name='explainability')(
        jnp.asarray(pred), jnp.asarray(target), mask=jnp.asarray(mask))[0])
    crit = tlosses.ReconstructionLoss(mask_name='explainability')
    monkeypatch.setattr(crit, 'apply_mask', lambda err, m: err)
    reduce = crit._reduce
    monkeypatch.setattr(crit, '_reduce', lambda err: reduce(err) * _t(mask).mean(-1, keepdim=True))
    got = crit(_t(pred), _t(target), mask=_t(mask))[0].item()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_a_masked_automask_refuses_the_untiled_source():
    """With a mask the static error needs the scale-tiled source (m == b), as
    the JAX package asserts."""
    rng = np.random.default_rng(4)
    pred, target, source, mask = _recon_inputs(rng)
    crit = tlosses.ReconstructionLoss(mask_name='uncertainty', use_automask=True)
    tiled = lambda a: torch.cat([_t(a)] * 2)  # noqa: E731
    with pytest.raises(ValueError, match='tiled source'):
        crit(torch.cat([_t(pred)] * 2, 1), tiled(target), source=_t(source),
             mask=tiled(mask), noise=torch.zeros(2 * B, 16, 24, 1))


# ------------------------------------------------------------- 2. the handlers
def _scales(rng, lo, hi, c=1, h=H, w=W, n_sc=2):
    return {s: (lo + (hi - lo) * rng.random((B, h, w, c))).astype(np.float32) for s in range(n_sc)}


def _poses(rng, n):
    aa = (0.02 * rng.standard_normal((n, B, 3))).astype(np.float32)
    t = (0.1 * rng.standard_normal((n, B, 3))).astype(np.float32)
    return aa, t


@pytest.mark.parametrize('mask_name', ['explainability', 'uncertainty'])
def test_masked_image_recon_matches_jax(mask_name):
    """`image_recon` with masks and the automask: the static error on the
    scale-tiled source with each scale's mask."""
    rng = np.random.default_rng(6)
    depths, masks = _scales(rng, 1, 10), _scales(rng, 0, 1, c=2)
    imgs = _images(rng)
    supp = np.stack([np.roll(imgs, 3, axis=2), np.roll(imgs, -3, axis=2)])
    aa, t = _poses(rng, 2)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (2 * B, H, W, 1)))
    kw = dict(use_min=True, use_automask=True, mask_name=mask_name)

    def jfn(depths, masks, aa, t):
        Ts = jops.T_from_AAt(aa, t)
        return jh.image_recon(jlosses.ReconstructionLoss(**kw), depths, masks, jnp.asarray(imgs),
                              jnp.asarray(supp), Ts, jnp.asarray(_K()), rng=key)[0]

    def tfn(depths, masks, aa, t):
        Ts = tops.T_from_AAt(aa, t)
        return th.image_recon(tlosses.ReconstructionLoss(**kw), depths, _t(imgs), _t(supp), Ts,
                              _t(_K()), noise=_t(noise), masks=masks)[0]

    _assert_same(*_grads(jfn, tfn, depths, masks, aa, t))


def _stereo_inputs(rng):
    disps, disps_st = _scales(rng, 0.05, 0.5), _scales(rng, 0.05, 0.5)
    depths = {s: 1.0 / d for s, d in disps.items()}
    depths_st = {s: 1.0 / d for s, d in disps_st.items()}
    return disps, depths, disps_st, depths_st


def test_stereo_const_matches_jax():
    """One warp of [stereo, mono] disparities (C = 1) by [T, T^-1], both signs
    of T_stereo in the batch; gradients w.r.t. the warped disparities too
    (the warp's image cotangent, `ops/sample.py:_Warp.backward`)."""
    rng = np.random.default_rng(8)
    args = _stereo_inputs(rng)
    T, K = _T_stereo(), _K()
    crit_j, crit_t = jlosses.RegressionLoss('l1'), tlosses.RegressionLoss('l1')
    jv, jg, tv, tg = _grads(
        lambda *a: jh.stereo_const(crit_j, *a, jnp.asarray(T), jnp.asarray(K))[0],
        lambda *a: th.stereo_const(crit_t, *a, _t(T), _t(K))[0], *args)
    _assert_same(jv, jg, tv, tg)
    assert np.abs(tg[0][0]).max() > 0  # the warped source's own gradient
    jld = jh.stereo_const(crit_j, *jax.tree.map(jnp.asarray, args), jnp.asarray(T),
                          jnp.asarray(K))[1]
    tld = th.stereo_const(crit_t, *jax.tree.map(_t, args), _t(T), _t(K))[1]
    for k in ('disps_warp', 'stereo_disps_warp'):
        _close(tld[k].numpy(), jld[k], 1e-5, k)


def test_stereo_const_differential_has_teeth(monkeypatch):
    """The mono disparity warped by T instead of T^-1 (a swapped sign) fails."""
    rng = np.random.default_rng(8)
    args = _stereo_inputs(rng)
    T, K = _T_stereo(), _K()
    want = float(jh.stereo_const(jlosses.RegressionLoss('l1'), *jax.tree.map(jnp.asarray, args),
                                 jnp.asarray(T), jnp.asarray(K))[0])
    monkeypatch.setattr(th, 'rigid_inverse', lambda T: T)
    got = th.stereo_const(tlosses.RegressionLoss('l1'), *jax.tree.map(_t, args), _t(T),
                          _t(K))[0].item()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def _regr_inputs(rng):
    imgs = _images(rng)
    supp = np.stack([np.roll(imgs, 3, axis=2), np.roll(imgs, -3, axis=2)])
    hints = _hints(rng)
    depths = {s: np.where(hints > 0, hints, 5.0) * (1 + 0.2 * rng.standard_normal(hints.shape))
              .astype(np.float32) for s in range(2)}
    depths = {s: np.clip(d, 0.5, None).astype(np.float32) for s, d in depths.items()}
    aa, t = _poses(rng, 2)
    return depths, hints, imgs, supp, aa, t


def check_gate(got: np.ndarray, want: np.ndarray, margin: np.ndarray,
               near: float = GATE_MARGIN) -> int:
    """A binary gate of the port against the JAX package's: bits may differ only
    where the JAX side's margin is within `near` of 0 (float32 chains in
    another order), and at most GATE_SHARE of them -> the number that differ."""
    diff = got != want
    assert diff.mean() <= GATE_SHARE, (int(diff.sum()), diff.size)
    assert np.all(np.abs(margin[diff]) < near), np.abs(margin[diff]).max()
    return int(diff.sum())


class RecordingRegression(tlosses.RegressionLoss):
    """The port's regression loss, keeping the mask it was given (scale-tiled)."""

    def __call__(self, pred, target, mask=None):
        self.seen = mask
        return super().__call__(pred, target, mask)


@pytest.mark.parametrize('automask', [False, True], ids=['no_automask', 'automask'])
def test_depth_regr_matches_jax(automask):
    """Proxy-depth regression (log-l1) on the valid hints, with and without the
    Depth-Hints automask (`photo(depth warp) > photo(hint warp)`, min over the
    supports as `img_recon`'s `compute_photo` reduces).

    The gate has no tie-break: its bits are held by `check_gate`. The loss
    and its gradients are then held at LOSS_RTOL / GRAD_ATOL to the JAX
    regression taken over the port's gate, and the loss to the JAX handler's
    within 1e-3 (one flipped pixel of ~10^4 valid ones moves the masked mean
    by ~1e-4)."""
    rng = np.random.default_rng(9)
    depths, hints, imgs, supp, aa, t = _regr_inputs(rng)
    jrecon = jlosses.ReconstructionLoss(use_min=True)
    trecon = tlosses.ReconstructionLoss(use_min=True)
    jc = jlosses.RegressionLoss('log_l1', use_automask=automask)
    tc = RecordingRegression('log_l1', use_automask=automask)
    Tj = jops.T_from_AAt(jnp.asarray(aa), jnp.asarray(t))
    Tt = tops.T_from_AAt(_t(aa), _t(t))
    K = _K()
    jv, jld = jh.depth_regr(jc, jrecon.compute_photo, jax.tree.map(jnp.asarray, depths),
                            jnp.asarray(hints), jnp.asarray(imgs), jnp.asarray(supp), Tj,
                            jnp.asarray(K))

    def tfn(depths):
        return th.depth_regr(tc, trecon.compute_photo, depths, _t(hints), _t(imgs), _t(supp),
                             Tt, _t(K))

    tv, tld = tfn(jax.tree.map(_t, depths))
    gate = tc.seen.numpy()
    targets = np.concatenate([hints] * 2)
    assert ('automask_hints' in tld) == automask
    if automask:
        cat = lambda a: jnp.concatenate([a] * 2, axis=1)  # noqa: E731
        Ts_s, Ks_s = cat(Tj), jnp.concatenate([jnp.asarray(K)] * 2)
        s_imgs = jnp.asarray(np.concatenate([imgs] * 2))
        depths_s = jnp.concatenate([jnp.asarray(depths[s]) for s in (0, 1)])
        margin = np.asarray(
            jrecon.compute_photo(jh._batched_synth(cat(jnp.asarray(supp)), depths_s, Ts_s, Ks_s),
                                 s_imgs)
            - jrecon.compute_photo(jh._batched_synth(cat(jnp.asarray(supp)),
                                                     jnp.asarray(targets), Ts_s, Ks_s), s_imgs))
        want_bits = np.asarray(jld['automask_hints'])
        np.testing.assert_array_equal(want_bits, (margin > 0)[:B])
        assert 0.2 < want_bits.mean() < 0.8
        check_gate(gate, (targets > 0) & (margin > 0), margin)
        valid = targets[:B] > 0
        np.testing.assert_array_equal(tld['automask_hints'].numpy()[valid], gate[:B][valid])
    else:
        np.testing.assert_array_equal(gate, targets > 0)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-3 if automask else LOSS_RTOL)

    def jmasked(depths):  # the JAX regression over the port's gate
        return jc(jnp.concatenate([depths[s] for s in (0, 1)]), jnp.asarray(targets),
                  jnp.asarray(gate))[0]
    _assert_same(*_grads(jmasked, lambda d: tfn(d)[0], depths))
    np.testing.assert_array_equal(tld['mask_regr'].numpy(), gate[:B].astype(np.float32))


def test_depth_regr_differential_has_teeth():
    """The hint automask the wrong way round (keep the hints that reconstruct
    worse) fails."""
    rng = np.random.default_rng(9)
    depths, hints, imgs, supp, aa, t = _regr_inputs(rng)
    Tj = jops.T_from_AAt(jnp.asarray(aa), jnp.asarray(t))
    want = float(jh.depth_regr(
        jlosses.RegressionLoss('log_l1', use_automask=True),
        jlosses.ReconstructionLoss(use_min=True).compute_photo, jax.tree.map(jnp.asarray, depths),
        jnp.asarray(hints), jnp.asarray(imgs), jnp.asarray(supp), Tj, jnp.asarray(_K()))[0])
    photo = tlosses.ReconstructionLoss(use_min=True).compute_photo
    got = th.depth_regr(tlosses.RegressionLoss('log_l1', use_automask=True),
                        lambda p, t: -photo(p, t), jax.tree.map(_t, depths), _t(hints),
                        _t(imgs), _t(supp), tops.T_from_AAt(_t(aa), _t(t)), _t(_K()))[0].item()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_disp_occ_and_disp_mask_handlers_match_jax():
    rng = np.random.default_rng(10)
    disps = {s: rng.random((B, H >> s, W >> s, 1), dtype=np.float32) for s in range(3)}
    masks = {s: rng.random((B, H >> s, W >> s, 2), dtype=np.float32) for s in range(3)}
    _assert_same(*_grads(lambda d: jh.disp_occ(jlosses.OccReg(invert=True), d)[0],
                         lambda d: th.disp_occ(tlosses.OccReg(invert=True), d)[0], disps))
    _assert_same(*_grads(lambda m: jh.disp_mask(jlosses.MaskReg(), m)[0],
                         lambda m: th.disp_mask(tlosses.MaskReg(), m)[0], masks))


# ---------------------------------------------- 3. the trainer on given outputs
# Every loss of this slice at once, with virtual stereo and masks. `img_recon`
# takes no mask here: its stereo view has none (the JAX trainer raises too).
# The hint automask is held by `test_depth_regr_matches_jax` (its margins are
# read there) and in the Depth-Hints family.
ALL_LOSSES_CFG = {
    'net': {'depth': {'enc_name': 'convnext_atto', 'pretrained': False, 'out_scales': [0, 1],
                      'use_virtual_stereo': True, 'mask_name': 'explainability',
                      'num_ch_mask': 3},
            'pose': {'enc_name': 'convnext_atto', 'pretrained': False}},
    'loss': {'img_recon': {'weight': 1, 'use_min': True, 'use_automask': True},
             'stereo_const': {'weight': 1, 'loss_name': 'l1'},
             'depth_regr': {'weight': 1, 'loss_name': 'log_l1'},
             'disp_smooth': {'weight': 0.001, 'use_edges': True, 'use_laplacian': True,
                             'use_blur': True},
             'disp_occ': {'weight': 0.01},
             'disp_mask': {'weight': 0.2}},
    'trainer': {'min_depth': 0.1, 'max_depth': 100},
}
ALL_SUPP = (-1, 1, 0)


def _outputs(rng):
    """The nets' outputs at 2 scales, NHWC: mono and [left, right] disparities,
    masks, two poses."""
    disp = {s: rng.uniform(0.01, 0.2, (B, H >> s, W >> s, 1)).astype(np.float32) for s in (0, 1)}
    disp_st = {s: rng.uniform(0.01, 0.2, (B, H >> s, W >> s, 2)).astype(np.float32) for s in (0, 1)}
    mask = {s: rng.uniform(0.2, 1, (B, H >> s, W >> s, 3)).astype(np.float32) for s in (0, 1)}
    aa, t = _poses(rng, 2)
    return disp, disp_st, mask, aa, t


def _jax_loss(cfg, x, y, key, fault=None):
    trainer = JaxTrainer(cfg)

    def fn(disp, disp_st, mask, aa, t):
        Ts = jops.T_from_AAt(aa, t)
        fwd = {'disp': disp, 'disp_stereo': disp_st, 'mask': mask, 'T_-1': Ts[0], 'T_1': Ts[1]}
        fwd = trainer.forward_postprocess(fwd, x, y, ALL_SUPP)
        return trainer.forward_loss(fwd, x, y, ALL_SUPP, key)
    return fn


def _port_loss(trainer, x, y, noise):
    def fn(disp, disp_st, mask, aa, t):
        Ts = tops.T_from_AAt(aa, t)
        fwd = {'disp': disp, 'disp_stereo': disp_st, 'mask': mask, 'T_-1': Ts[0], 'T_1': Ts[1]}
        fwd = trainer.forward_postprocess(fwd, x, y, ALL_SUPP)
        return trainer.forward_loss(fwd, y, noise=noise, supp_idxs=ALL_SUPP)
    return fn


@pytest.fixture(scope='module')
def all_losses():
    rng = np.random.default_rng(11)
    outs = _outputs(rng)
    x, y = make_batch(ALL_SUPP, hints=True, seed=12)
    key = jax.random.PRNGKey(13)
    jfn = _jax_loss(ALL_LOSSES_CFG, jax.tree.map(jnp.asarray, x), jax.tree.map(jnp.asarray, y), key)
    (jv, jld), jg = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(5)), has_aux=True))(
        *jax.tree.map(jnp.asarray, outs))
    noise = jax_noise(ALL_LOSSES_CFG, key, (2 * B, H, W, 1))
    return {'outs': outs, 'x': x, 'y': y, 'noise': noise, 'jv': float(jv),
            'jld': jax.tree.map(np.asarray, jld), 'jg': jax.tree.map(np.asarray, jg)}


def _run_port_all(all_losses, trainer=None):
    trainer = trainer or MonoDepthTrainer(ALL_LOSSES_CFG)
    x, y = (jax.tree.map(_t, b) for b in (all_losses['x'], all_losses['y']))
    fn = _port_loss(trainer, x, y, _t(all_losses['noise']))
    targs = jax.tree.map(lambda a: _t(a).requires_grad_(), all_losses['outs'])
    loss, ld = fn(*targs)
    loss.backward()
    return loss.item(), ld, jax.tree.map(lambda a: a.grad.numpy(), targs)


def test_every_loss_branch_matches_jax(all_losses):
    """Loss terms, summaries and gradients w.r.t. every network output. The
    automask's bits may flip where err and the noisy static error sit within
    float32 agreement (measured 1 of 12288): the loss takes their minimum, so
    a flip there does not move it, but the pixel's depth gradient follows the
    other branch of the minimum. So up to GATE_SHARE of a gradient tensor's
    elements may be off (measured 3 of 12288), the rest within GRAD_ATOL."""
    tv, tld, tg = _run_port_all(all_losses)
    jld = all_losses['jld']
    assert sorted(tld) == sorted(jld)
    assert {'loss_stereo_img_recon', 'loss_stereo_disp_smooth', 'stereo_automask',
            'stereo_supp_imgs_warp', 'disps_warp', 'stereo_disps_warp'} <= set(tld)
    for k in tld:
        if k.startswith('loss_'):
            np.testing.assert_allclose(tld[k].item(), jld[k], rtol=LOSS_RTOL, err_msg=k)
        elif tld[k].dtype == torch.bool:
            assert (tld[k].numpy() != jld[k]).mean() <= GATE_SHARE, k
        else:  # warped frames and disparities: folded geometry in another order
            _close(tld[k].detach().numpy(), jld[k], GRAD_ATOL, k)
    _assert_same(all_losses['jv'], all_losses['jg'], tv, tg, outliers=GATE_SHARE)


def test_every_loss_branch_has_teeth(all_losses):
    """The virtual-stereo channel picked by the opposite sign of T_stereo fails."""
    trainer = MonoDepthTrainer(ALL_LOSSES_CFG)
    post = trainer.forward_postprocess

    def flipped(fwd, x, y, supp_idxs):
        y = dict(y, T_stereo=y['T_stereo'] * torch.tensor([[1, 1, 1, -1]] + [[1, 1, 1, 1]] * 3))
        out = post(fwd, x, y, supp_idxs)
        out['Ts'] = torch.stack([y['T_stereo'] * torch.tensor([[1, 1, 1, -1]] + [[1, 1, 1, 1]] * 3)
                                 if i == 0 else out[f'T_{i}'] for i in supp_idxs])
        return out

    trainer.forward_postprocess = flipped
    tv, _, _ = _run_port_all(all_losses, trainer)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(tv, all_losses['jv'], rtol=LOSS_RTOL)


def test_missing_inputs_raise():
    """As the JAX trainer: KeyError without `T_stereo`, `disp_stereo`,
    `depth_hints` or `mask`."""
    rng = np.random.default_rng(11)
    disp, disp_st, mask, aa, t = jax.tree.map(_t, _outputs(rng))
    trainer = MonoDepthTrainer(ALL_LOSSES_CFG)
    x, y = (jax.tree.map(_t, b) for b in make_batch(ALL_SUPP, hints=True, seed=12))
    Ts = tops.T_from_AAt(aa, t)
    fwd = {'disp': disp, 'mask': mask, 'T_-1': Ts[0], 'T_1': Ts[1]}
    with pytest.raises(KeyError, match='T_stereo'):
        trainer.forward_postprocess(dict(fwd, disp_stereo=disp_st), x,
                                    {k: v for k, v in y.items() if k != 'T_stereo'}, (-1, 1))
    post = trainer.forward_postprocess(dict(fwd), x, y, ALL_SUPP)
    with pytest.raises(KeyError, match='disp_stereo'):
        trainer.forward_loss(post, y, noise=torch.zeros(2 * B, H, W, 1), supp_idxs=ALL_SUPP)
    post = trainer.forward_postprocess(dict(fwd, disp_stereo=disp_st), x, y, ALL_SUPP)
    with pytest.raises(KeyError, match='depth_hints'):
        trainer.forward_loss(post, {k: v for k, v in y.items() if k != 'depth_hints'},
                             noise=torch.zeros(2 * B, H, W, 1), supp_idxs=ALL_SUPP)
    post = trainer.forward_postprocess({k: v for k, v in fwd.items() if k != 'mask'}
                                       | {'disp_stereo': disp_st}, x, y, ALL_SUPP)
    with pytest.raises(KeyError, match='mask'):
        trainer.forward_loss(post, y, noise=torch.zeros(2 * B, H, W, 1), supp_idxs=ALL_SUPP)


# ------------------------------------------------- 4. the trainer with nets
@functools.lru_cache(maxsize=None)
def jax_family(name: str) -> dict:
    """Micro-step 1 of a family's cfg in the JAX package (one jit of its
    loss and gradient): loss, loss terms, every gradient in the port's keys."""
    cfg = family_cfg(name)
    supp = supp_of(cfg)
    x, y = make_batch(supp, hints='depth_regr' in cfg['loss'], seed=20)
    params, _ = convert_reference_ckpt(seeded_weights(cfg), cfg)
    jt = JaxTrainer(cfg)
    jx, jy = jax.tree.map(jnp.asarray, (x, y))
    (jv, (jld, _, _)), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, {}, jx, jy, supp, jax.random.PRNGKey(21), True),
        has_aux=True))(params)
    return {'loss': float(jv), 'terms': {k: float(v) for k, v in jld.items()
                                         if k.startswith('loss_')},
            'grads': port_layout(jax.tree.map(np.asarray, jg), cfg)}


def port_family(name: str) -> dict:
    """The same micro-step in the port, on the CPU, from the same weights."""
    cfg = family_cfg(name)
    supp = supp_of(cfg)
    x, y = make_batch(supp, hints='depth_regr' in cfg['loss'], seed=20)
    trainer = port_trainer(cfg, seeded_weights(cfg))
    trainer.nets.train()
    loss, (ld, _) = trainer.loss_fn(*jax.tree.map(_t, (x, y)), supp)
    loss.backward()
    return {'loss': loss.item(), 'terms': {k: v.item() for k, v in ld.items()
                                           if k.startswith('loss_')},
            'grads': {f'{n}.{k}': p.grad.numpy() for n, net in trainer.nets.items()
                      for k, p in net.named_parameters()}}


@pytest.mark.parametrize('name', ['sfm_learner', 'klodt'])
def test_mask_family_loss_and_gradients_match_jax(name):
    """No automask in these cfgs, so no tie-break noise to hand over."""
    want, got = jax_family(name), port_family(name)
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=LOSS_RTOL)
    assert sorted(got['terms']) == sorted(want['terms'])
    for k, v in got['terms'].items():
        np.testing.assert_allclose(v, want['terms'][k], rtol=LOSS_RTOL, err_msg=k)
    assert compare_grads(got['grads'], want['grads']) == []
    mask_grads = [k for k in got['grads'] if k.startswith('depth.decoders.mask')]
    assert mask_grads and all(np.abs(got['grads'][k]).max() > 0 for k in mask_grads)


def test_mask_family_differential_has_teeth(monkeypatch):
    """SfM-Learner with each support's mask applied to the other support fails."""
    recon = th.image_recon
    monkeypatch.setattr(th, 'image_recon', lambda *a, masks=None, **kw: recon(
        *a, masks={s: m.flip(-1) for s, m in masks.items()}, **kw))
    got = port_family('sfm_learner')
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got['loss'], jax_family('sfm_learner')['loss'],
                                   rtol=LOSS_RTOL)


# ------------------------------------------------------ 5. every cfg of the families
def _cfg_files():
    out = []
    for d in ('benchmark', 'benchmark_ours', 'abl_smooth'):
        out += sorted((CFG / d).glob('*.yaml'))
    return out


def _load(path: Path) -> dict:
    """A cfg over its directory's `default.yaml`; `cfg/abl_smooth/` has no net
    section and rides on `cfg/benchmark/default.yaml`, as `tests/test_configs.py`
    merges it."""
    chain = [path.parent / 'default.yaml', path]
    if path.parent.name == 'abl_smooth':
        chain.insert(0, CFG / 'benchmark' / 'default.yaml')
    if path.stem == 'default':
        chain = chain[:-1]
    return load_merge_yaml(*chain)


_A10 = 'queue A item 10'
# cfg -> (as it stands, with the pose encoder overlaid to convnext_tiny): None builds
# a `MonoDepthTrainer`, else the ROADMAP item its refusal names. Every cfg builds: the
# published ResNet-18 pose net (A10a), Depth-VO-Feat's and FeatDepth's feature losses
# and autoencoder (A9b), and the HR-Depth, DDV-Net, DiffNet, CADepth and SuperDepth
# decoders (A10b).
FAMILIES = {
    **{f'benchmark/{n}': (None, None) for n in (
        'cadepth_MS', 'ddvnet', 'default', 'depth_hints_MS', 'depth_vo_feat', 'diffnet_MS',
        'dvso', 'feat_depth', 'garg', 'hrdepth_M', 'hrdepth_MS', 'klodt', 'kuznietsov',
        'monodepth', 'monodepth2_M', 'monodepth2_MS', 'monoresmatch', 'sfm_learner',
        'superdepth')},
    **{f'benchmark_ours/{n}': (None, None) for n in (
        'default', 'ours', 'ours_hints', 'ours_min', 'ours_monodepth', 'ours_none',
        'ours_nosmooth')},
    **{f'abl_smooth/{n}': (None, None) for n in (
        'blur', 'default', 'laplacian', 'laplacian_blur', 'none', 'occlusion', 'occlusion_inv')},
}


def test_the_pinned_cfgs_are_every_cfg():
    assert sorted(FAMILIES) == sorted(f'{p.parent.name}/{p.stem}' for p in _cfg_files())


@pytest.mark.parametrize('overlay', [False, True], ids=['as_it_stands', 'pose_convnext_tiny'])
@pytest.mark.parametrize('path', _cfg_files(), ids=lambda p: f'{p.parent.name}/{p.stem}')
def test_every_family_cfg_builds_or_names_its_item(path, overlay, tmp_path, monkeypatch, caplog):
    """Built on the meta device (shapes only), with no weights file under the
    model root: a ConvNeXt with `pretrained: True` warns and keeps its draw."""
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path])
    cfg = _load(path)
    if overlay and cfg['net'].get('pose'):
        cfg['net']['pose']['enc_name'] = 'convnext_tiny'
    want = FAMILIES[f'{path.parent.name}/{path.stem}'][overlay]
    with torch.device('meta'), caplog.at_level(logging.WARNING):
        if want is not None:
            with pytest.raises(NotImplementedError, match=want):
                MonoDepthTrainer(cfg)
            return
        trainer = MonoDepthTrainer(cfg)
    assert set(trainer.losses) == {k for k, v in cfg['loss'].items() if v is not None}
    assert ('pose' in trainer.nets) == bool(cfg['net'].get('pose'))
    if 'pose' not in trainer.nets:
        assert supp_of(cfg) == (0,)
    assert 'No pretrained weights for "convnext_base"' in caplog.text


def _backbone_files():
    return sorted((CFG / 'abl_pretrained').glob('*.yaml')) + sorted((CFG / 'abl_bb').glob('*.yaml'))


def _load_backbone(path: Path) -> dict:
    """`cfg/benchmark/default.yaml` -> the directory's `default.yaml` -> the file, as
    `tests/test_configs.py` merges the `abl_*` cfgs."""
    chain = [CFG / 'benchmark' / 'default.yaml', path.parent / 'default.yaml', path]
    return load_merge_yaml(*(chain[:-1] if path.stem == 'default' else chain))


# cfg -> None (builds as it stands; a ResNet or ResNeXt one also trains a micro-step) or
# the ROADMAP item its refusal names (the MobileNet, EfficientNet and HRNet encoders).
BACKBONES = {
    **{f'abl_pretrained/{n}': None for n in (
        'default', 'resnet101', 'resnet101_pt', 'resnet18', 'resnet18_pt', 'resnet50',
        'resnet50_pt', 'resnext101', 'resnext101_pt', 'resnext101_pt_ssl', 'resnext101_pt_swsl')},
    **{f'abl_bb/{n}': None for n in (
        'convnext_base', 'convnext_large', 'convnext_tiny', 'default', 'resnet101', 'resnet18')},
    **{f'abl_bb/{n}': _A10 for n in (
        'efficientnet_b0', 'efficientnet_b4', 'hrnet_w18', 'hrnet_w64', 'mobilenetv3_large_100',
        'mobilenetv3_small_050')},
}
CUT_LAYERS = (1, 1, 1, 1)


def test_the_pinned_backbone_cfgs_are_every_cfg():
    assert sorted(BACKBONES) == sorted(f'{p.parent.name}/{p.stem}' for p in _backbone_files())


@pytest.mark.parametrize('path', _backbone_files(), ids=lambda p: f'{p.parent.name}/{p.stem}')
def test_every_backbone_cfg_builds_or_names_its_item(path, tmp_path, monkeypatch, caplog):
    """As it stands on the meta device, with no weights file under the model root; then
    a ResNet or ResNeXt depth net trains one micro-step on the CPU at a cut size: every
    ResNet one block a stage (widths, groups and block type as published), 2 scales,
    B=2, 64x96: a finite loss, every parameter finite, each BatchNorm counted once."""
    from slowtv_monodepth_tpu_torch.models.encoders import RESNET_SPECS
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path])
    cfg = _load_backbone(path)
    want = BACKBONES[f'{path.parent.name}/{path.stem}']
    with torch.device('meta'):
        if want is not None:
            with pytest.raises(NotImplementedError, match=want):
                MonoDepthTrainer(cfg)
            return
        MonoDepthTrainer(cfg)
    enc = cfg['net']['depth']['enc_name']
    if enc not in RESNET_SPECS:
        return
    for name in {enc, cfg['net']['pose']['enc_name']}:
        monkeypatch.setitem(RESNET_SPECS, name, dict(RESNET_SPECS[name], layers=CUT_LAYERS))
    cfg['net']['depth']['out_scales'] = [0, 1]
    torch.manual_seed(0)
    with caplog.at_level(logging.WARNING):
        trainer = MonoDepthTrainer(cfg)
    if cfg['net']['depth']['pretrained']:
        assert f'No pretrained weights for "{enc}"' in caplog.text
    before = {k: p.detach().clone() for k, p in trainer.nets.named_parameters()}
    opt = parsers.make_optimizer(cfg, trainer.nets)
    step = trainer.make_step_fn(supp_of(cfg), opt)
    x, y = make_batch(supp_of(cfg), hints=False, seed=30)
    scalars = step(*jax.tree.map(_t, (x, y)), generator=torch.Generator().manual_seed(0))
    assert np.isfinite(scalars['loss'].item())
    assert all(torch.isfinite(p).all() for p in trainer.nets.parameters())
    assert sum(not torch.equal(p, before[k]) for k, p in trainer.nets.named_parameters()) \
        > 0.9 * len(before)
    counts = [int(b) for k, b in trainer.nets.named_buffers() if k.endswith('num_batches_tracked')]
    assert counts and set(counts) == {1}


def _benchmark_files():
    """Every cfg of `cfg/benchmark/` but `default.yaml`, the base each one merges
    (it names no support frame, so it has no image to reconstruct)."""
    return [p for p in sorted((CFG / 'benchmark').glob('*.yaml')) if p.stem != 'default']


@pytest.mark.parametrize('path', _benchmark_files(), ids=lambda p: p.stem)
def test_every_benchmark_cfg_trains_a_micro_step(path, tmp_path, monkeypatch):
    """`cfg/benchmark/default.yaml` + the file as it stands (no weights file under the
    model root), cut to this file's test size: the depth encoder overlaid to
    convnext_atto behind the cfg's own decoder, it and the ResNet-18 pose net and
    autoencoder one block a stage (`CUT_LAYERS`), 2 scales, B=2, 64x96. One micro-step: a finite
    loss, every parameter finite and most of them updated, each BatchNorm counted
    once (FeatDepth's autoencoder twice: target and support passes), and each output
    at its decoder's resolution (SuperDepth's at full resolution); behind the
    HR-Depth, DDV-Net, DiffNet, CADepth and SuperDepth decoders also the image
    logger's rerun of the batch (eval mode). Kuznietsov keeps
    the default pose net with the stereo frame as its only support: the pose net has
    no pair to see and the step raises, as the JAX package's does (its
    `jnp.stack` of no pair, `core/trainer.py:156`)."""
    from slowtv_monodepth_tpu_torch.models.encoders import CONVNEXT_SPECS, RESNET_SPECS
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path])
    monkeypatch.setitem(RESNET_SPECS, 'resnet18', dict(RESNET_SPECS['resnet18'],
                                                       layers=CUT_LAYERS))
    monkeypatch.setitem(CONVNEXT_SPECS, 'convnext_atto', dict(CONVNEXT_SPECS['convnext_atto'],
                                                              depths=CUT_LAYERS))
    cfg = _load(path)
    cfg['net']['depth'].update(enc_name='convnext_atto', out_scales=[0, 1])
    supp = supp_of(cfg)
    torch.manual_seed(0)
    trainer = MonoDepthTrainer(cfg)
    before = {k: p.detach().clone() for k, p in trainer.nets.named_parameters()}
    opt = parsers.make_optimizer(cfg, trainer.nets)
    x, y = make_batch(supp, hints='depth_regr' in cfg['loss'], seed=31)
    x, y = jax.tree.map(_t, (x, y))
    step = trainer.make_step_fn(supp, opt)
    if cfg['net'].get('pose') and set(supp) == {0}:
        with pytest.raises(RuntimeError, match='non-empty'):
            step(x, y, generator=torch.Generator().manual_seed(0))
        return
    scalars = step(x, y, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(scalars['loss'].item())
    assert all(torch.isfinite(p).all() for p in trainer.nets.parameters())
    assert sum(not torch.equal(p, before[k]) for k, p in trainer.nets.named_parameters()) \
        > 0.9 * len(before)
    counts = {n: {int(b) for k, b in net.named_buffers() if k.endswith('num_batches_tracked')}
              for n, net in trainer.nets.items()}
    assert counts == {n: {2} if n == 'autoencoder' else {1} if c else set()
                      for n, c in counts.items()}
    assert counts.get('pose', {1}) == {1}
    with torch.no_grad():
        disp = trainer.nets['depth'].eval()(x['imgs'].permute(0, 3, 1, 2))['disp']
    full = cfg['net']['depth']['dec_name'] == 'superdepth'
    assert {s: tuple(d.shape[2:]) for s, d in disp.items()} == {
        s: (H, W) if full else (H >> s, W >> s) for s in (0, 1)}

    class Images:  # the image logger's writer interface
        def __init__(self):
            self.images = {}

        def add_images(self, tag, img, global_step):
            self.images[tag] = img

        def add_text(self, tag, text, global_step):
            pass
    if cfg['net']['depth']['dec_name'] == 'monodepth':  # the other families: their PRs' tests
        return
    writer = Images()
    HeavyLogger().log_step(trainer, (x, y, {}), supp, writer, epoch=0)
    assert 'train_pred/disp' in writer.images and all(
        g.shape[:2] == (1, 3) and np.isfinite(g).all() for g in writer.images.values())


# -------------------------------------------------------- 6. the DVSO training run
N_FRAMES = 26


def _write_dvso_pack(root: Path) -> None:
    """A KITTI pack store with what `dvso.yaml`'s datum reads: both cameras'
    images, benchmark depth, velodyne scans with their calibration, and SGBM
    hints, laid out as `api/data/pack/build.py:build_kitti` writes them."""
    import io

    from PIL import Image

    from slowtv_monodepth_tpu.databases import write_image_database, write_label_database

    def png(arr, mode=None):
        b = io.BytesIO()
        Image.fromarray(arr, mode).save(b, 'PNG')
        return b.getvalue()

    rng = np.random.default_rng(0)
    seq, drive = '2011_09_26', '2011_09_26_drive_0001_sync'
    P = np.array([[721.5, 0, 609.6, 0], [0, 721.5, 172.9, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    write_label_database({
        'cam2cam/R_rect_00': np.eye(3), 'cam2cam/P_rect_02': P, 'cam2cam/P_rect_03': P,
        'cam2cam/S_rect_02': np.array([1242, 375]), 'cam2cam/S_rect_03': np.array([1242, 375]),
        'velo2cam/R': np.array([[0.0, -1, 0], [0, 0, -1], [1, 0, 0]]),
        'velo2cam/T': np.zeros(3)}, root / seq / 'calibration')
    scans = {}
    for i in range(N_FRAMES):
        pts = np.stack([rng.uniform(5, 40, 3000), rng.uniform(-8, 8, 3000),
                        rng.uniform(-1.5, 1, 3000), np.ones(3000)], -1).astype(np.float32)
        scans[f'{i:010d}'] = pts
    write_label_database(scans, root / seq / drive / 'velodyne_points' / 'data')
    for cam in ('image_02', 'image_03'):
        write_image_database({f'{i:010d}': png(rng.integers(0, 255, (48, 160, 3), dtype=np.uint8))
                              for i in range(N_FRAMES)}, root / seq / drive / cam / 'data')
        write_image_database(
            {f'{i:010d}': png((rng.random((48, 160)) * 50 * 256).astype(np.uint16), 'I;16')
             for i in range(N_FRAMES)},
            root / 'depth_benchmark' / seq / drive / 'proj_depth' / 'groundtruth' / cam)
        write_label_database({f'{i:010d}': _hints(rng, b=1, h=48, w=160)[0, ..., 0]
                              for i in range(N_FRAMES)}, root / 'depth_hints' / seq / drive / cam)
    split = root / 'splits' / 'tiny'
    split.mkdir(parents=True)
    (split / 'train_files.txt').write_text('\n'.join(f'{seq}/{drive} {i} l' for i in range(1, 19)))
    (split / 'test_files.txt').write_text('\n'.join(f'{seq}/{drive} {i} r' for i in range(1, 9)))


def test_dvso_trains_as_it_stands_on_the_cpu(tmp_path, monkeypatch, caplog):
    """`default.yaml` + `dvso.yaml` through `MonoDepthLoop` (what
    `slowtv-train-torch -c cfg/benchmark/default.yaml cfg/benchmark/dvso.yaml`
    runs), cut to test size: convnext_atto (pretrained, no file: the warning),
    the tiny split at 64x192, 4 items, batch 2, one epoch of 2 micro-steps and
    validation. A stereo-only support: `supp_idxs [0]`, no pose net,
    `T_stereo` from the dataset, `depth_hints` through derive-on-device and the
    loop's AR-aug call, which the benchmark cfgs leave at p = 0 (the
    augmentation refuses hints, as the JAX package's does)."""
    import random

    from slowtv_monodepth_tpu_torch.core import MonoDepthLoop
    from slowtv_monodepth_tpu_torch.core.aspect_ratio import aspect_ratio_aug
    from test_torch_loop import _Writer
    random.seed(0)
    np.random.seed(0)
    pack = tmp_path / 'kitti_raw_sync_lmdb'
    _write_dvso_pack(pack)
    monkeypatch.setitem(paths.DATA_PATHS, 'kitti_raw_lmdb', pack)
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path / 'models'])
    cfg = load_merge_yaml(CFG / 'benchmark' / 'default.yaml', CFG / 'benchmark' / 'dvso.yaml')
    cfg['net']['depth'].update(enc_name='convnext_atto')
    ds = cfg['dataset']['kitti_lmdb']
    ds.update(split='tiny', shape=[64, 192], max_len=4)
    cfg['loader'].update(batch_size=2, train={'num_workers': 0, 'shuffle': True},
                         val={'num_workers': 0, 'shuffle': False})
    cfg['trainer'].update(max_epochs=1, log_every_n_steps=1, limit_val_batches=1,
                          matmul='highest')
    writer = _Writer()
    with caplog.at_level(logging.WARNING):
        loop = MonoDepthLoop(cfg, tmp_path / 'run', device='cpu', writer=writer)
    assert 'No pretrained weights for "convnext_atto" under <model_root>/timm/' in caplog.text
    assert list(loop.trainer.nets) == ['depth']
    seen = []
    aug = loop.ar_aug

    def recording_aug(batch, **kw):
        out = aug(batch, **kw)
        seen.append({k: tuple(v.shape) for k, v in out[1].items() if hasattr(v, 'shape')})
        return out

    loop.ar_aug = recording_aug
    loop.fit()
    assert len(seen) == 2 and loop.global_step == 2
    for shapes in seen:
        assert shapes['imgs'] == (2, 64, 192, 3) and shapes['supp_imgs'] == (1, 2, 64, 192, 3)
        assert shapes['depth_hints'] == (2, 64, 192, 1) and shapes['T_stereo'] == (2, 4, 4)
    with pytest.raises(RuntimeError, match='depth hints'):
        aspect_ratio_aug(loop.last_batch[0], p=1.0)
    logged = {tag for tag, _, _ in writer.logged}
    assert {'train_losses/stereo_const', 'train_losses/depth_regr', 'train_losses/disp_occ',
            'train_losses/stereo_img_recon', 'train_losses/stereo_disp_smooth'} <= logged, logged
    assert all(np.isfinite(v) for _, v, _ in writer.logged)
    assert {'val_metrics/AbsRel', 'val_metrics/loss_stereo_const'} <= logged
    assert (tmp_path / 'run' / 'finished').is_file()
    for f in (tmp_path / 'run').rglob('*.ckpt'):
        f.unlink()


@pytest.mark.parametrize('mode', ['train', 'val'])
def test_chip_smoke_stand_in_yields_the_readers_layout(tmp_path, monkeypatch, mode):
    """`chip_smoke.StereoHintLoader` yields the keys (in order), dtypes and shapes that
    `kitti_lmdb` yields with `dvso.yaml`'s datum at the cfg's batch and shape."""
    import chip_smoke
    from test_torch_recipe import _layout
    pack = tmp_path / 'kitti_raw_sync_lmdb'
    _write_dvso_pack(pack)
    monkeypatch.setitem(paths.DATA_PATHS, 'kitti_raw_lmdb', pack)
    cfg = load_merge_yaml(CFG / 'benchmark' / 'default.yaml', CFG / 'benchmark' / 'dvso.yaml')
    cfg['dataset']['kitti_lmdb'].update(split='tiny', max_len=8)
    cfg['loader'].update(train={'num_workers': 0, 'shuffle': True},
                         val={'num_workers': 0, 'shuffle': False})
    assert cfg['loader']['batch_size'] == chip_smoke.FAMILY_B
    assert tuple(cfg['dataset']['kitti_lmdb']['shape']) == chip_smoke.FAMILY_SHAPE
    real = next(iter(parsers.get_dl(mode, cfg['dataset'], cfg['loader'])))
    scenes = [np.random.RandomState(i).rand(48, 64, 3).astype(np.float32) for i in range(2)]
    stand_in = next(iter(chip_smoke.StereoHintLoader(scenes, 1, mode == 'train')))
    assert _layout(stand_in) == _layout(real)
    T = stand_in[1]['T_stereo'][:, 0, 3]
    assert (T > 0).any() and (T < 0).any()


@pytest.mark.parametrize('name', ['dvso', 'depth_hints_MS', 'sfm_learner', 'klodt',
                                  'depth_vo_feat', 'feat_depth', 'hrdepth_MS', 'ddvnet',
                                  'diffnet_MS', 'cadepth_MS', 'superdepth'])
def test_chip_smoke_family_cfgs_are_the_files(name):
    """`chip_smoke.family_cfg` (no yaml on the card) is `default.yaml` + the family's file
    as they stand, the published ResNet-18 pose net included."""
    import chip_smoke
    want = load_merge_yaml(CFG / 'benchmark' / 'default.yaml', CFG / 'benchmark' / f'{name}.yaml')
    assert chip_smoke.family_cfg(name) == want


@pytest.mark.parametrize('name', ['benchmark/monodepth2_M', 'abl_pretrained/resnet18',
                                  'abl_pretrained/resnext101_pt_ssl'])
def test_chip_smoke_resnet_cfgs_are_the_files(name):
    """`chip_smoke.resnet_cfg` (no yaml on the card) is the cfg as `tests/test_configs.py`
    merges it: `cfg/benchmark/default.yaml` [-> the directory's `default.yaml`] -> the file."""
    import chip_smoke
    path = CFG / f'{name}.yaml'
    want = (_load_backbone(path) if path.parent.name.startswith('abl_')
            else load_merge_yaml(CFG / 'benchmark' / 'default.yaml', path))
    assert chip_smoke.resnet_cfg(name) == want


def test_the_warp_image_cotangent_runs_only_for_a_source_with_a_gradient(monkeypatch):
    """The photometric reconstruction warps data: its backward makes no 4-corner
    scatter-add. `stereo_const` warps disparities with a gradient: four `index_add_`
    calls in its one warp's backward."""
    calls = []
    index_add = torch.Tensor.index_add_
    monkeypatch.setattr(torch.Tensor, 'index_add_',
                        lambda self, *a, **kw: calls.append(1) or index_add(self, *a, **kw))
    rng = np.random.default_rng(6)
    depths = {s: _t(d).requires_grad_() for s, d in _scales(rng, 1, 10).items()}
    imgs = _images(rng)
    supp = np.stack([np.roll(imgs, 3, axis=2), np.roll(imgs, -3, axis=2)])
    Ts = tops.T_from_AAt(*(_t(a) for a in _poses(rng, 2)))
    loss, _ = th.image_recon(tlosses.ReconstructionLoss(), depths, _t(imgs), _t(supp), Ts, _t(_K()))
    loss.backward()
    assert calls == [] and depths[0].grad is not None
    args = jax.tree.map(lambda a: _t(a).requires_grad_(), _stereo_inputs(rng))
    th.stereo_const(tlosses.RegressionLoss('l1'), *args, _t(_T_stereo()), _t(_K()))[0].backward()
    assert len(calls) == 4


class _Images:
    def __init__(self):
        self.images = {}

    def add_images(self, tag, imgs, global_step):
        self.images[tag] = np.asarray(imgs)


def test_image_logger_panels_match_jax():
    """The virtual-stereo disparity, one mask panel per support and the hint
    automask: the JAX logger's tags and grids on the same host arrays."""
    from slowtv_monodepth_tpu.core.heavy_logger import HeavyLogger as JaxLogger
    from slowtv_monodepth_tpu_torch.core.heavy_logger import HeavyLogger
    rng = np.random.default_rng(14)
    fwd = {'disp': {0: rng.random((B, 16, 24, 1), dtype=np.float32)},
           'disp_stereo': {0: rng.random((B, 16, 24, 1), dtype=np.float32)},
           'mask': {0: rng.random((B, 16, 24, 2), dtype=np.float32)}}
    ld = {'automask_hints': rng.random((B, 16, 24, 1)) > 0.5,
          'supp_imgs_warp': rng.random((2, B, 16, 24, 3), dtype=np.float32)}
    out = []
    for cls in (HeavyLogger, JaxLogger):
        logger, w = cls(2, 2), _Images()
        logger.writer, logger.mode = w, 'train'
        logger.log_fwd(fwd, (-1, 1))
        logger.log_loss(ld, (-1, 1))
        out.append(w.images)
    assert sorted(out[0]) == sorted(out[1])
    assert {'train_pred/disp_stereo', 'train_pred/mask_-1', 'train_pred/mask_1',
            'train_loss/automask_hints'} <= set(out[0])
    for k in out[1]:
        np.testing.assert_array_equal(out[0][k], out[1][k], err_msg=k)


@pytest.mark.parametrize('key', ['no_such_loss', 'no_such_net'])
def test_the_a9b_keys_raise_naming_their_item(key):
    """A loss or net key no package knows raises `KeyError`, as the JAX parsers do.
    (Depth-VO-Feat's and FeatDepth's keys build since ROADMAP A9b: the cfg pins above.)"""
    if key == 'no_such_loss':
        with pytest.raises(KeyError, match='Unknown loss'):
            parsers.get_loss({key: {}})
    else:
        with pytest.raises(KeyError, match='Unknown network'):
            parsers.get_net({key: {}})


@pytest.mark.parametrize('loss_kw', [{}, {'loss_name': 'ssim', 'use_min': True}],
                         ids=['default', 'ssim'])
def test_feat_recon_with_ssim_is_refused_naming_t1(loss_kw):
    """`feat_recon` with the SSIM error (the default `loss_name`) would send 64-128
    feature channels to the photometric kernels, which take 1-4: refused when the cfg is
    parsed, on every device (ROADMAP trap T1). l1 and l2 build."""
    with pytest.raises(NotImplementedError, match='trap T1'):
        parsers.get_loss({'feat_recon': loss_kw})
    for name in ('l1', 'l2'):
        assert parsers.get_loss({'feat_recon': {**loss_kw, 'loss_name': name}})[0]['feat_recon']
