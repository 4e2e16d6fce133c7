"""Port differential: `parsers.get_opt` / `make_optimizer` vs the JAX package's optax chain.

A parameter tree with the shapes that matter (conv and dense kernels,
biases and norm scales, under `encoder` and not) gets the same seeded
gradients on both sides for 300 updates of 2 accumulated micro-steps each:
- the LR of every update against the JAX package's `get_sched`, with
  `steps_per_epoch=5` so StepLR x LinearLR move within the run;
- the parameters after the run, with and without `backbone_lr`;
- zero gradients: only the weight decay moves a parameter, so the decay
  mask shows by itself (ndim > 1 only on the module path, every parameter
  on the `backbone_lr` path).

Tolerance: parameters atol 3e-6 after 300 updates of about lr = 1e-3 each,
starting from weights of magnitude ~0.05, as a net's are: the parameters
travel up to ~0.3, float32 rounds each update to their ulp (up to ~3e-8)
in another order on the two sides, and 300 updates drift apart by up to
1.3e-6 (measured). With zero gradients (decay only) atol 1e-8. LRs rtol
1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from slowtv_monodepth_tpu import parsers as jparsers
from slowtv_monodepth_tpu_torch import parsers
from torch_threads import two_torch_threads  # noqa: F401

SHAPES = {'depth.encoder.conv': (8, 4, 3, 3), 'depth.encoder.norm': (8,),
          'depth.decoder.conv': (4, 8, 3, 3), 'depth.decoder.bias': (4,),
          'pose.encoder.fc': (6, 5), 'pose.head.gamma': (6,)}
SCHED = {'steplr': {'step_size': 40, 'gamma': 0.1},
         'linear': {'start_factor': 0.1, 'total_iters': 4}}
STEPS_PER_EPOCH = 5
UPDATES, ACCUMULATE = 300, 2


def _tree(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split('.')
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flat(tree: dict, pre='') -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{pre}{k}.'))
        else:
            out[f'{pre}{k}'] = np.asarray(v)
    return out


class Params(nn.Module):
    def __init__(self, init: dict):
        super().__init__()
        self.p = nn.ParameterDict({k.replace('.', '__'): nn.Parameter(torch.tensor(v))
                                   for k, v in init.items()})

    def named_parameters(self, *a, **kw):  # the dotted names the decay split reads
        return ((k.replace('__', '.'), p) for k, p in self.p.items())

    def flat(self) -> dict:
        return {k.replace('__', '.'): p.detach().numpy() for k, p in self.p.items()}


def _run(opt_cfg: dict, zero_grads: bool = False):
    rs = np.random.RandomState(0)
    init = {k: (0.05 * rs.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (0 if zero_grads else 1) * rs.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(UPDATES * ACCUMULATE)]
    cfg = {'optimizer': opt_cfg, 'scheduler': SCHED}

    tx = jparsers.make_optimizer(cfg, steps_per_epoch=STEPS_PER_EPOCH, accumulate=ACCUMULATE)
    params = jax.tree.map(jnp.asarray, _tree(init))
    state = tx.init(params)
    update = jax.jit(tx.update)
    for g in grads:
        upd, state = update(jax.tree.map(jnp.asarray, _tree(g)), state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)

    module = Params(init)
    opt = parsers.make_optimizer(cfg, module, steps_per_epoch=STEPS_PER_EPOCH,
                                 accumulate=ACCUMULATE)
    lrs = []
    for g in grads:
        for k, p in module.named_parameters():
            p.grad = torch.tensor(g[k]) if p.grad is None else p.grad + torch.tensor(g[k])
        if opt.micro == ACCUMULATE - 1:
            lrs.append(opt.lrs())
        opt.step()
    assert opt.updates == UPDATES
    return _flat(params), module.flat(), init, lrs


@pytest.mark.parametrize('opt_cfg', [
    {'type': 'adamw', 'lr': 1e-3, 'weight_decay': 1e-2},
    {'type': 'adamw', 'lr': 1e-3, 'weight_decay': 1e-2, 'backbone_lr': 1e-4},
    {'type': 'adamw', 'lr': 1e-3},
])
def test_updates_match_optax(opt_cfg):
    want, got, _, lrs = _run(opt_cfg)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], atol=3e-6, err_msg=k)
    sched = jparsers.get_sched(SCHED, opt_cfg['lr'], STEPS_PER_EPOCH)
    for u, lr in enumerate(lrs):
        np.testing.assert_allclose(lr[-1], float(sched(u)), rtol=1e-6, err_msg=f'update {u}')


@pytest.mark.parametrize('backbone', [False, True])
def test_decay_mask_matches_optax(backbone):
    opt_cfg = {'type': 'adamw', 'lr': 1e-3, 'weight_decay': 1e-2}
    if backbone:
        opt_cfg['backbone_lr'] = 1e-4
    want, got, init, _ = _run(opt_cfg, zero_grads=True)
    for k, shape in SHAPES.items():
        moved = not np.array_equal(want[k], init[k])
        assert moved == (backbone or len(shape) > 1), k
        np.testing.assert_allclose(got[k], want[k], atol=1e-8, err_msg=k)


def test_differential_has_teeth(monkeypatch):
    """Decaying every parameter on the module path (every tensor seen as 2-D
    by the decay split) fails the zero-grad run."""
    monkeypatch.setattr(torch.Tensor, 'ndim', property(lambda t: 2))
    with pytest.raises(AssertionError):
        test_decay_mask_matches_optax(False)


def test_unported_options_raise():
    module = Params({'a': np.zeros(2, np.float32)})
    with pytest.raises(NotImplementedError):
        parsers.get_opt({'type': 'lamb'}, module)
    with pytest.raises(NotImplementedError):
        parsers.get_opt({'type': 'adamw', 'frozen_bn': True}, module)
    with pytest.raises(NotImplementedError):
        parsers.get_loss({'feat_recon': {}})
