"""Port differential: aspect-ratio augmentation (`core.aspect_ratio`) vs the JAX package's.

- The host sampling: the same `random.Random(seed)` gives the same crop,
  ratio and bucket in both modules over 200 consecutive draws, and leaves both
  generators in the same state (the same number of draws in the same order).
- `crop_resize`, `_adjust_K` and `aspect_ratio_aug` on a batch of seeded
  numpy inputs; `all_output_shapes` as sets.
The JAX side resamples through its warp kernel in interpret mode
(`SLOWTV_FORCE_PALLAS_WARP`), the port on the CPU through the plain version.

Tolerances: resampled images atol 2e-5 (a 4-corner bilinear of values in
[0, 1]; the sample coords go through the same float32 expressions), 1e-4 for
the standardized net inputs of a batch (values up to ~2.5), adjusted K rtol
1e-6 (four float32 multiplies).
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu.core import aspect_ratio as jar
from slowtv_monodepth_tpu_torch.core import aspect_ratio as tar
from torch_threads import two_torch_threads  # noqa: F401

ATOL = 2e-5


def test_ratios_and_labels_agree():
    assert tar.LABELS == jar.LABELS and tar.RATIOS == jar.RATIOS


@pytest.mark.parametrize('shape,ref', [((720, 1280), (384, 640)), ((376, 1242), (384, 640)),
                                       ((128, 192), (128, 192))])
def test_same_seed_same_sequence(shape, ref):
    """200 draws of the loop's per-batch sampling (gate, crop, resize)."""
    ra, rb = random.Random(42 * 7919 + 3), random.Random(42 * 7919 + 3)
    for _ in range(200):
        fired = ra.random() <= 0.7
        assert fired == (rb.random() <= 0.7)
        if not fired:
            assert tar.sample_resize(shape, ref, eps=1.0) == jar.sample_resize(shape, ref, eps=1.0)
            continue
        (crop_a, r_a), (crop_b, r_b) = (m.sample_crop(shape, 0.5, 1.0, rng=r)
                                        for m, r in ((tar, ra), (jar, rb)))
        assert crop_a == crop_b and r_a == r_b
        assert tar.sample_resize(crop_a, ref) == jar.sample_resize(crop_b, ref)
    assert ra.getstate() == rb.getstate()


def test_sequence_check_has_teeth():
    """Drawing the ratio before the candidate sizes gives another sequence."""
    def reordered(shape, lo, hi, rng):
        r = rng.choice(tar.RATIOS)
        crop, _ = tar.sample_crop(shape, lo, hi, rng=rng)
        return crop, r
    ra, rb = random.Random(5), random.Random(5)
    draws_a = [reordered((720, 1280), 0.5, 1.0, ra) for _ in range(20)]
    draws_b = [jar.sample_crop((720, 1280), 0.5, 1.0, rng=rb) for _ in range(20)]
    assert draws_a != draws_b


def test_all_output_shapes_equal_as_sets():
    for srcs, ref in (([(720, 1280)], (384, 640)), ([(376, 1242), (720, 1280)], (384, 640)),
                      ([(96, 128)], (64, 96))):
        assert tar.all_output_shapes(srcs, ref) == jar.all_output_shapes(srcs, ref)


@pytest.mark.parametrize('crop,out', [((60, 100), (64, 96)), ((37, 81), (32, 64)),
                                      ((72, 128), (96, 160))])
def test_crop_resize_matches_jax(monkeypatch, crop, out):
    monkeypatch.setenv('SLOWTV_FORCE_PALLAS_WARP', '1')
    img = np.random.RandomState(0).rand(2, 72, 128, 3).astype(np.float32)
    want = jar.crop_resize(jnp.asarray(img), jnp.asarray(crop, jnp.float32), out)
    got = tar.crop_resize(torch.from_numpy(img), crop, out)
    assert tuple(got.shape) == want.shape == (2,) + out + (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_crop_resize_differential_has_teeth(monkeypatch):
    """A crop anchored at the top-left corner instead of the centre fails."""
    monkeypatch.setenv('SLOWTV_FORCE_PALLAS_WARP', '1')
    img = np.random.RandomState(0).rand(2, 72, 128, 3).astype(np.float32)
    want = jar.crop_resize(jnp.asarray(img), jnp.asarray((60, 100), jnp.float32), (64, 96))
    got = tar.crop_resize(torch.from_numpy(img[:, :60, :100].copy()), (60, 100), (64, 96))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_adjust_K_matches_jax():
    K = np.random.RandomState(1).rand(3, 4, 4).astype(np.float32) * 100
    want = jar._adjust_K(jnp.asarray(K), jnp.asarray((60., 100.)), (72, 128), (64, 96))
    Kt = torch.from_numpy(K.copy())
    got = tar._adjust_K(Kt, (60, 100), (72, 128), (64, 96))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(Kt.numpy(), K)  # the input is left alone


def _batch(rs, b=2, h=96, w=128, n=2):
    imgs = rs.rand(b, h, w, 3).astype(np.float32)
    supp = rs.rand(n, b, h, w, 3).astype(np.float32)
    K = np.broadcast_to(np.array([[0.6 * w, 0, 0.5 * w, 0], [0, 0.9 * h, 0.5 * h, 0],
                                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32), (b, 4, 4)).copy()
    x = {'imgs': (imgs - 0.45) / 0.22, 'supp_imgs': (supp - 0.45) / 0.22}
    return x, {'imgs': imgs, 'supp_imgs': supp, 'K': K}


@pytest.mark.parametrize('seed,p', [(0, 1.0), (1, 1.0), (2, 1.0), (3, 0.0)])
def test_aspect_ratio_aug_on_a_batch_matches_jax(monkeypatch, seed, p):
    """p=1: crop + resize; p=0 with another ref shape: the plain resize path."""
    monkeypatch.setenv('SLOWTV_FORCE_PALLAS_WARP', '1')
    x, y = _batch(np.random.RandomState(seed))
    kw = dict(p=p, crop_min=0.5, crop_max=1.0, ref_shape=(64, 96))
    jx, jy, jm = jar.aspect_ratio_aug(
        tuple({k: jnp.asarray(v) for k, v in d.items()} for d in (x, y)) + ({},),
        rng=random.Random(seed), **kw)
    tx, ty, tm = tar.aspect_ratio_aug(
        tuple({k: torch.from_numpy(v) for k, v in d.items()} for d in (x, y)) + ({},),
        rng=random.Random(seed), **kw)
    assert tm == jm
    for got, want in ((tx, jx), (ty, jy)):
        assert set(got) == set(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            tol = dict(rtol=1e-6) if k == 'K' else dict(atol=ATOL * (5 if got is tx else 1))
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **tol)
    assert tx['imgs'].shape[1] % 32 == 0 and tx['imgs'].shape[2] % 32 == 0


def test_depth_hints_are_refused():
    x, y = _batch(np.random.RandomState(0))
    y['depth_hints'] = y['imgs'][..., :1]
    batch = tuple({k: torch.from_numpy(v) for k, v in d.items()} for d in (x, y)) + ({},)
    with pytest.raises(RuntimeError, match='depth hints'):
        tar.aspect_ratio_aug(batch, p=1.0, ref_shape=(64, 96), rng=random.Random(0))
