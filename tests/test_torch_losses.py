"""Port differentials for the training path's geometry, losses and handlers.

Same numpy inputs on both sides, float32; the port on the CPU.
- geometry: `T_from_AAt`, `resize_K`, `rigid_inverse`, the folded
  `view_synth` (warped image, depth, validity) and its gradients;
- losses: `PhotoError` on an (n, b) stack (one flattened call),
  `ReconstructionLoss` with min-reprojection and automask (fed JAX's own
  tie-break noise), `SmoothReg` with edges;
- handlers: `image_recon` (scale stacking, one batched view synthesis, the
  untiled static source) and `disp_smooth`, values and gradients w.r.t.
  depths, disparities and poses.
The JAX side forces its warp and photometric kernels (interpret mode), as
the train step uses them.

Tolerances: geometry atol 1e-5 relative to the magnitude (a few float32
products; `inv(K)` by different LU codes); losses rtol 1e-5; gradients
atol 1e-4 of the largest magnitude (float32 chains through the warp and the
SSIM ratio).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu import ops as jops
from slowtv_monodepth_tpu.core import handlers as jh
from slowtv_monodepth_tpu.losses import PhotoError as JaxPhotoError
from slowtv_monodepth_tpu.losses import ReconstructionLoss as JaxRecon
from slowtv_monodepth_tpu.losses import SmoothReg as JaxSmooth
from slowtv_monodepth_tpu_torch import ops as tops
from slowtv_monodepth_tpu_torch.core import handlers as th
from slowtv_monodepth_tpu_torch.losses import PhotoError, ReconstructionLoss, SmoothReg
from torch_threads import two_torch_threads  # noqa: F401

B, H, W = 2, 16, 24
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _force_kernels(monkeypatch):
    monkeypatch.setenv('SLOWTV_FORCE_PALLAS_WARP', '1')
    monkeypatch.setenv('SLOWTV_FORCE_PALLAS_PHOTO', '1')


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _poses(rs, n):
    aa = (0.05 * rs.standard_normal((n, 3))).astype(np.float32)
    t = (0.1 * rs.standard_normal((n, 3))).astype(np.float32)
    return aa, t


def _K(n):
    K = np.array([[0.6 * W, 0, 0.5 * W, 0], [0, 1.9 * H, 0.5 * H, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    return np.ascontiguousarray(np.broadcast_to(K, (n, 4, 4)))


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(got, want, atol=rtol * max(1.0, float(np.abs(want).max())))


def test_pose_and_intrinsics_math_match_jax():
    aa, t = _poses(np.random.RandomState(0), 5)
    T = np.asarray(jops.T_from_AAt(jnp.asarray(aa), jnp.asarray(t)))
    _close(tops.T_from_AAt(_t(aa), _t(t)).numpy(), T)
    _close(th.rigid_inverse(_t(T)).numpy(), np.asarray(jh.rigid_inverse(jnp.asarray(T))))
    _close(tops.resize_K(_t(_K(3)), (H, W)).numpy(),
           np.asarray(jops.resize_K(jnp.asarray(_K(3)), (H, W))))


def test_view_synth_and_grads_match_jax():
    rs = np.random.RandomState(1)
    img = rs.rand(B, H, W, 3).astype(np.float32)
    depth = rs.uniform(1, 10, (B, H, W, 1)).astype(np.float32)
    aa, t = _poses(rs, B)
    K = _K(B)
    cot = rs.standard_normal((B, H, W, 3)).astype(np.float32)

    def jloss(d, a, tt):
        warped, dw, valid = jops.view_synth(jnp.asarray(img), d, jops.T_from_AAt(a, tt),
                                            jnp.asarray(K))
        return (warped * cot).sum(), (warped, dw, valid)
    (_, (jw, jd, jv)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (depth, aa, t)))

    leaves = [_t(v).requires_grad_() for v in (depth, aa, t)]
    warped, dw, valid = tops.view_synth(_t(img), leaves[0], tops.T_from_AAt(*leaves[1:]), _t(K))
    (warped * _t(cot)).sum().backward()
    _close(warped.detach().numpy(), np.asarray(jw))
    _close(dw.detach().numpy(), np.asarray(jd))
    assert (valid.numpy() == np.asarray(jv)).mean() > 0.999  # float32 edge cases at |grid| ~ 1
    for got, want in zip(leaves, jg):
        _close(got.grad.numpy(), np.asarray(want), GRAD_RTOL)


def _stack(rs, n=2):
    pred = rs.rand(n, B, H, W, 3).astype(np.float32)
    target = rs.rand(B, H, W, 3).astype(np.float32)
    return pred, target


def test_photo_error_stack_matches_jax():
    pred, target = _stack(np.random.RandomState(2))
    want = np.asarray(JaxPhotoError(0.85)(jnp.asarray(pred), jnp.asarray(target)))
    got = PhotoError(0.85)(_t(pred), _t(target)).numpy()
    assert got.shape == want.shape == (2, B, H, W, 1)
    _close(got, want)


@pytest.mark.parametrize('weight_ssim', [0.85, 0.0])
@pytest.mark.parametrize('stacked', [False, True])
def test_photo_error_weights_and_ranks_match_jax(weight_ssim, stacked):
    """One (b, h, w, c) frame or an (n, b) stack; SSIM + L1 or L1 alone."""
    pred, target = _stack(np.random.RandomState(9))
    pred = pred if stacked else pred[0]
    want = np.asarray(JaxPhotoError(weight_ssim)(jnp.asarray(pred), jnp.asarray(target)))
    got = PhotoError(weight_ssim)(_t(pred), _t(target)).numpy()
    assert got.shape == want.shape == pred.shape[:-1] + (1,)
    _close(got, want)


@pytest.mark.parametrize('dtype', [torch.float64, torch.bfloat16])
def test_photo_error_raises_on_a_dtype_the_kernels_do_not_take(dtype):
    """The SSIM term goes through `photo_err_ssim` whatever the dtype: no
    second path that would skip the kernels on the card."""
    pred, target = _stack(np.random.RandomState(10))
    with pytest.raises(TypeError, match='float32'):
        PhotoError(0.85)(_t(pred).to(dtype), _t(target).to(dtype))


@pytest.mark.parametrize('use_min,use_automask', [(True, True), (False, False), (True, False)])
def test_reconstruction_loss_matches_jax(use_min, use_automask):
    rs = np.random.RandomState(3)
    pred, target = _stack(rs)
    source = rs.rand(2, B, H, W, 3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jl, jld = JaxRecon(use_min=use_min, use_automask=use_automask)(
        *map(jnp.asarray, (pred, target, source)), rng=key)
    noise = np.asarray(jax.random.normal(key, (B, H, W, 1)))
    tl, tld = ReconstructionLoss(use_min=use_min, use_automask=use_automask)(
        _t(pred), _t(target), source=_t(source), noise=_t(noise))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    if use_automask:
        assert (tld['automask'].numpy() == np.asarray(jld['automask'])).mean() > 0.999


def test_automask_needs_noise_or_generator():
    pred, target = _stack(np.random.RandomState(5))
    crit = ReconstructionLoss(use_min=True, use_automask=True)
    with pytest.raises(ValueError):
        crit(_t(pred), _t(target), source=_t(pred))
    loss, _ = crit(_t(pred), _t(target), source=_t(pred), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)


def test_smooth_reg_matches_jax():
    rs = np.random.RandomState(6)
    disp = rs.rand(B, H, W, 1).astype(np.float32)
    img = rs.rand(B, H, W, 3).astype(np.float32)
    (jl, jld), jg = jax.value_and_grad(lambda d: JaxSmooth(use_edges=True)(d, jnp.asarray(img)),
                                       has_aux=True)(jnp.asarray(disp))
    d = _t(disp).requires_grad_()
    tl, tld = SmoothReg(use_edges=True)(d, _t(img))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    _close(d.grad.numpy(), np.asarray(jg), GRAD_RTOL)
    for k in ('disp_grad', 'image_grad'):
        _close(tld[k].numpy(), np.asarray(jld[k]))


def _handler_inputs(rs):
    depths = {s: rs.uniform(1, 10, (B, H, W, 1)).astype(np.float32) for s in range(4)}
    disps = {s: rs.rand(B, H >> s, W >> s, 1).astype(np.float32) for s in range(4)}
    imgs = rs.rand(B, H, W, 3).astype(np.float32)
    supp = np.stack([np.roll(imgs, 1, 2), np.roll(imgs, -1, 2)])
    aa, t = _poses(rs, 2 * B)
    return depths, disps, imgs, supp, aa, t, _K(B)


def test_image_recon_and_disp_smooth_match_jax():
    depths, disps, imgs, supp, aa, t, K = _handler_inputs(np.random.RandomState(7))
    key = jax.random.PRNGKey(8)

    def jloss(depths, disps, aa, t):
        Ts = jops.T_from_AAt(aa, t).reshape(2, B, 4, 4)
        l1, _ = jh.image_recon(JaxRecon(use_min=True, use_automask=True), depths, None,
                               jnp.asarray(imgs), jnp.asarray(supp), Ts, jnp.asarray(K), rng=key)
        l2, _ = jh.disp_smooth(JaxSmooth(use_edges=True), disps, jnp.asarray(imgs))
        return l1 + 0.001 * l2, (l1, l2)
    jargs = (jax.tree.map(jnp.asarray, depths), jax.tree.map(jnp.asarray, disps),
             jnp.asarray(aa), jnp.asarray(t))
    (_, (jl1, jl2)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(*jargs)
    noise = np.asarray(jax.random.normal(key, (4 * B, H, W, 1)))

    td = {s: _t(v).requires_grad_() for s, v in depths.items()}
    tp = {s: _t(v).requires_grad_() for s, v in disps.items()}
    ta, tt = _t(aa).requires_grad_(), _t(t).requires_grad_()
    Ts = tops.T_from_AAt(ta, tt).reshape(2, B, 4, 4)
    l1, ld = th.image_recon(ReconstructionLoss(use_min=True, use_automask=True), td,
                            _t(imgs), _t(supp), Ts, _t(K), noise=_t(noise))
    l2, _ = th.disp_smooth(SmoothReg(use_edges=True), tp, _t(imgs))
    (l1 + 0.001 * l2).backward()
    np.testing.assert_allclose(l1.item(), float(jl1), rtol=1e-5)
    np.testing.assert_allclose(l2.item(), float(jl2), rtol=1e-5)
    assert ld['supp_imgs_warp'].shape == (2, B, H, W, 3) and ld['automask'].shape == (B, H, W, 1)
    for s in range(4):
        _close(td[s].grad.numpy(), np.asarray(jg[0][s]), GRAD_RTOL)
        _close(tp[s].grad.numpy(), np.asarray(jg[1][s]), GRAD_RTOL)
    _close(ta.grad.numpy(), np.asarray(jg[2]), GRAD_RTOL)
    _close(tt.grad.numpy(), np.asarray(jg[3]), GRAD_RTOL)


def test_image_recon_differential_has_teeth(monkeypatch):
    """Targets tiled across scales in another batch order than the warped
    stack (a stacking slip) fail."""
    depths, _, imgs, supp, aa, t, K = _handler_inputs(np.random.RandomState(7))
    key = jax.random.PRNGKey(8)
    Ts = jops.T_from_AAt(jnp.asarray(aa), jnp.asarray(t)).reshape(2, B, 4, 4)
    jl, _ = jh.image_recon(JaxRecon(use_min=True, use_automask=True),
                           jax.tree.map(jnp.asarray, depths), None, jnp.asarray(imgs),
                           jnp.asarray(supp), Ts, jnp.asarray(K), rng=key)
    noise = np.asarray(jax.random.normal(key, (4 * B, H, W, 1)))
    monkeypatch.setattr(th, '_tile_scales', lambda x, n: torch.cat([x.flip(0)] * n))
    tl, _ = th.image_recon(ReconstructionLoss(use_min=True, use_automask=True),
                           {s: _t(v) for s, v in depths.items()}, _t(imgs), _t(supp),
                           tops.T_from_AAt(_t(aa), _t(t)).reshape(2, B, 4, 4), _t(K),
                           noise=_t(noise))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)


@pytest.mark.parametrize('fault', ['rotation_transposed', 'align_corners', 'no_mean_normalize'])
def test_geometry_and_smoothness_differentials_have_teeth(monkeypatch, fault):
    """A transposed Rodrigues rotation, `align_corners=True` pixel coords in
    the warp, or a smoothness loss on the raw disparity each fail."""
    rs = np.random.RandomState(1)
    if fault == 'rotation_transposed':
        aa, t = _poses(rs, 5)
        want = np.asarray(jops.T_from_AAt(jnp.asarray(aa), jnp.asarray(t)))
        got = tops.T_from_AAt(_t(-aa), _t(t)).numpy()  # R(-aa) = R(aa)^T
    elif fault == 'align_corners':
        from slowtv_monodepth_tpu_torch.ops import sample
        img = rs.rand(B, H, W, 3).astype(np.float32)
        depth = rs.uniform(1, 10, (B, H, W, 1)).astype(np.float32)
        aa, t = _poses(rs, B)
        T = jops.T_from_AAt(jnp.asarray(aa), jnp.asarray(t))
        want = np.asarray(jops.view_synth(jnp.asarray(img), jnp.asarray(depth), T,
                                          jnp.asarray(_K(B)))[0])
        monkeypatch.setattr(sample, '_unnormalize', lambda g, size: (g + 1.0) * (size - 1) / 2.0)
        got = tops.view_synth(_t(img), _t(depth), _t(np.asarray(T)), _t(_K(B)))[0].numpy()
    else:
        from slowtv_monodepth_tpu_torch.losses import regularizers
        disp = (0.1 * rs.rand(B, H, W, 1)).astype(np.float32)
        img = rs.rand(B, H, W, 3).astype(np.float32)
        want = float(JaxSmooth(use_edges=True)(jnp.asarray(disp), jnp.asarray(img))[0])
        monkeypatch.setattr(regularizers, 'mean_normalize', lambda x: x)
        got = SmoothReg(use_edges=True)(_t(disp), _t(img))[0].item()
    with pytest.raises(AssertionError):
        _close(got, want)
