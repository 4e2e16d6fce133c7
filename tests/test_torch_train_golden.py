"""The port reproduces the KBR training golden on the CPU (plain versions).

The fixture, its configuration and the comparison are described in
`slowtv_monodepth_tpu_torch/train_golden.py`; `chip_smoke.py` holds the
kernels on the card to the same fixture.

Regenerate the fixture: `python tests/test_torch_train_golden.py` (from the
repo root; a few minutes on the CPU).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

if __name__ == '__main__':  # run as a script from the repo root
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from slowtv_monodepth_tpu_torch import train_golden as tg  # noqa: E402
from torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope='module')
def golden():
    return tg.load_fixture()


def test_port_reproduces_the_training_golden(golden):
    got = tg.port_step(golden, 'cpu')
    assert got['grad_finite_nonzero']
    assert tg.compare(got, golden) == []


def test_port_with_fused_blocks_reproduces_the_training_golden(golden):
    """`fused_blocks: True` on both nets: every ConvNeXt block one fused call
    (its plain version on the CPU), the same weights, the same golden."""
    got = tg.port_step(golden, 'cpu', fused_blocks=True)
    assert got['grad_finite_nonzero']
    assert tg.compare(got, golden) == []


def test_training_golden_is_informative(golden):
    """A loss that moves with one update, grads spread over the nets."""
    assert 0.01 < float(golden['loss']) < 1
    assert float(golden['loss_after_update']) != float(golden['loss'])
    assert (golden['grad_norms'] > 0).all()
    assert len(golden['grad_names']) > 500


def write_fixture() -> None:
    import os

    import jax
    import jax.numpy as jnp

    from slowtv_monodepth_tpu import parsers as jparsers
    from slowtv_monodepth_tpu.core.trainer import MonoDepthTrainer as JaxTrainer
    from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
    from slowtv_monodepth_tpu_torch.models import (depth_state_dict_from_jax,
                                                   pose_state_dict_from_jax)

    os.environ['SLOWTV_FORCE_PALLAS_WARP'] = os.environ['SLOWTV_FORCE_PALLAS_PHOTO'] = '1'
    cfg, b, h, w = tg.CFG, tg.B, tg.H, tg.W
    sd = {f'nets.{n}.{k}': v for n, net_sd in tg.seeded_weights(tg.SEED).items()
          for k, v in net_sd.items()}
    params, _ = convert_reference_ckpt(sd, cfg)
    imgs = np.random.RandomState(1).rand(b, h, w, 3).astype(np.float32)
    x, y = (jax.tree.map(jnp.asarray, d) for d in tg.make_batch(imgs))
    key = jax.random.PRNGKey(3)
    trainer = JaxTrainer(cfg)
    tx = jparsers.make_optimizer(cfg, steps_per_epoch=1, accumulate=1)

    @jax.jit
    def run(params):
        (loss, (ld, _, _)), grads = jax.value_and_grad(trainer.loss_fn, has_aux=True)(
            params, {}, x, y, tg.SUPP, key, True)
        upd, _ = tx.update(grads, tx.init(params), params)
        new = jax.tree.map(lambda p, u: p + u, params, upd)
        after = trainer.loss_fn(new, {}, x, y, tg.SUPP, key, True)[0]
        return loss, ld['loss_img_recon'], ld['loss_disp_smooth'], grads, after

    loss, l_recon, l_smooth, grads, after = jax.tree.map(np.asarray, run(params))
    _, rng_loss = jax.random.split(key)
    noise = jax.random.normal(jax.random.split(rng_loss, len(cfg['loss']))[0],
                              (4 * b, h, w, 1))
    port = {'depth': depth_state_dict_from_jax(grads['depth'], cfg['net']['depth']['out_scales']),
            'pose': pose_state_dict_from_jax(grads['pose'])}
    flat = {f'{n}.{k}': v.numpy() for n, sd in port.items() for k, v in sd.items()}
    names = sorted(flat)
    tg.FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(
        tg.FIXTURE, seed=np.int64(tg.SEED), imgs=imgs, noise=np.asarray(noise, np.float32),
        loss=loss, loss_img_recon=l_recon, loss_disp_smooth=l_smooth, loss_after_update=after,
        grad_names=np.array(names), grad_norms=np.array([np.linalg.norm(flat[k]) for k in names]),
        **{f'grad:{k}': flat[k] for k in tg.WHOLE})
    print(f'wrote {tg.FIXTURE} ({tg.FIXTURE.stat().st_size} bytes); loss {float(loss)!r}, '
          f'after one update {float(after)!r}')


if __name__ == '__main__':
    import jax
    jax.config.update('jax_platforms', 'cpu')
    write_fixture()
