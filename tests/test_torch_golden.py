"""The golden fixture `chip_smoke.py` holds the port to on the card.

`tests/fixtures/torch_port_golden.npz` holds an input (2, 64, 96, 3) and the
4 disparity scales of the JAX package's KBR depth net (ConvNeXt-B +
monodepth, full width) with weights drawn by the port's
`models.seeded_state_dict(seed)` and carried into JAX by
`convert_reference_ckpt`. These tests check that both the JAX package and
the port (plain versions, CPU) still produce it.

Regenerate: `python tests/test_torch_golden.py` (from the repo root).

Tolerance: atol 1e-5 on sigmoid disparities (float32, 36 residual blocks;
port vs JAX measured ~1e-6).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401

FIXTURE = Path(__file__).parent / 'fixtures' / 'torch_port_golden.npz'
SEED = 0
ATOL = 1e-5
CFG = {'enc_name': 'convnext_base', 'dec_name': 'monodepth', 'out_scales': [0, 1, 2, 3]}


def seeded_weights(seed: int = SEED) -> dict:
    from slowtv_monodepth_tpu_torch.models import DepthNet, seeded_state_dict
    with torch.device('meta'):
        meta = DepthNet(**CFG)
    return seeded_state_dict(meta, seed)


def jax_disp(sd: dict, x: np.ndarray) -> list:
    """The JAX package's disparities (op-by-op: no whole-net compile)."""
    import jax.numpy as jnp

    from slowtv_monodepth_tpu.models import DepthNet
    from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
    params, _ = convert_reference_ckpt({f'nets.depth.{k}': v for k, v in sd.items()},
                                       {'net': {'depth': CFG}})
    out = DepthNet(**CFG, pretrained=False).apply(
        {'params': params['depth']}, jnp.asarray(x), train=False)['disp']
    return [np.asarray(out[s]) for s in range(4)]


def port_disp(sd: dict, x: np.ndarray) -> list:
    from slowtv_monodepth_tpu_torch.models import DepthNet
    net = DepthNet(**CFG).eval()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2))['disp']
    return [out[s].permute(0, 2, 3, 1).numpy() for s in range(4)]


@pytest.fixture(scope='module')
def golden():
    with np.load(FIXTURE) as f:
        gold = {k: f[k] for k in f.files}
    return gold, seeded_weights(int(gold['seed']))


@pytest.mark.parametrize('side', ['jax', 'port'])
def test_golden_fixture_still_matches(golden, side):
    gold, sd = golden
    disp = (jax_disp if side == 'jax' else port_disp)(sd, gold['x'])
    for s in range(4):
        assert disp[s].shape == gold[f'disp_{s}'].shape
        np.testing.assert_allclose(disp[s], gold[f'disp_{s}'], atol=ATOL,
                                   err_msg=f'{side} disp[{s}]')


def test_golden_fixture_is_informative(golden):
    """Disparities spread well inside (0, 1): the blocks and decoder matter."""
    gold, _ = golden
    for s in range(4):
        d = gold[f'disp_{s}']
        assert 0.01 < d.min() and d.max() < 0.99 and d.std() > 0.05


def write_fixture() -> None:
    x = np.random.RandomState(1).standard_normal((2, 64, 96, 3)).astype(np.float32)
    disp = jax_disp(seeded_weights(SEED), x)
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, seed=np.int64(SEED), x=x,
                        **{f'disp_{s}': d for s, d in enumerate(disp)})
    print(f'wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)')


if __name__ == '__main__':
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax
    jax.config.update('jax_platforms', 'cpu')
    write_fixture()
