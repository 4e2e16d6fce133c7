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

The other five optimizers (`adam`, `sgd`, `lamb`, `adabelief`, `rmsprop`,
optax's definitions in the port's `optim.py`) run 5 updates of 2
accumulated micro-steps under the schedule at `steps_per_epoch=1` (the LR
moves every update), with and without `backbone_lr` and `grad_clip`: the
parameters within 1e-6 of each tensor's largest magnitude (a float32 ulp
there is 6e-8 of it; an update of lr = 1e-3 moves a parameter by ~2% of
it, so an update off by 1e-4 of itself shows). `torch.optim.RMSprop` in
place of the port's fails.
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


def _run(opt_cfg: dict, zero_grads: bool = False, updates: int = UPDATES,
         steps_per_epoch: int = STEPS_PER_EPOCH, grad_clip=None):
    rs = np.random.RandomState(0)
    init = {k: (0.05 * rs.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (0 if zero_grads else 1) * rs.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(updates * ACCUMULATE)]
    cfg = {'optimizer': opt_cfg, 'scheduler': SCHED}

    tx = jparsers.make_optimizer(cfg, steps_per_epoch=steps_per_epoch, accumulate=ACCUMULATE,
                                 grad_clip=grad_clip)
    params = jax.tree.map(jnp.asarray, _tree(init))
    state = tx.init(params)
    update = jax.jit(tx.update)
    for g in grads:
        upd, state = update(jax.tree.map(jnp.asarray, _tree(g)), state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)

    module = Params(init)
    opt = parsers.make_optimizer(cfg, module, steps_per_epoch=steps_per_epoch,
                                 accumulate=ACCUMULATE, grad_clip=grad_clip)
    lrs = []
    for g in grads:
        for k, p in module.named_parameters():
            p.grad = torch.tensor(g[k]) if p.grad is None else p.grad + torch.tensor(g[k])
        if opt.micro == ACCUMULATE - 1:
            lrs.append(opt.lrs())
        opt.step()
    assert opt.updates == updates
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
    with pytest.raises(KeyError, match='Unknown optimizer "nadam"'):
        parsers.get_opt({'type': 'nadam'}, module)
    with pytest.raises(NotImplementedError, match='flatten'):
        parsers.get_opt({'type': 'adamw', 'flatten': True}, module)
    with pytest.raises(NotImplementedError):
        parsers.get_loss({'feat_recon': {}})


# ------------------------------------------------------------- the other five optimizers
OPTAX_CASES = {
    'adam': {'type': 'adam', 'lr': 1e-3},
    'adam_nesterov_backbone': {'type': 'adam', 'lr': 1e-3, 'nesterov': True, 'eps_root': 1e-8,
                               'backbone_lr': 1e-4},
    'sgd_nesterov': {'type': 'sgd', 'lr': 1e-2, 'momentum': 0.9, 'nesterov': True},
    'sgd_backbone': {'type': 'sgd', 'lr': 1e-2, 'backbone_lr': 1e-3},
    'lamb_masked': {'type': 'lamb', 'lr': 1e-3, 'weight_decay': 1e-2},
    'lamb_backbone': {'type': 'lamb', 'lr': 1e-3, 'weight_decay': 1e-2, 'backbone_lr': 1e-4},
    'adabelief': {'type': 'adabelief', 'lr': 1e-3},
    'adabelief_nesterov_backbone': {'type': 'adabelief', 'lr': 1e-3, 'nesterov': True,
                                    'backbone_lr': 1e-4},
    'rmsprop': {'type': 'rmsprop', 'lr': 1e-3},
    'rmsprop_centered_momentum': {'type': 'rmsprop', 'lr': 1e-3, 'centered': True,
                                  'momentum': 0.9, 'nesterov': True, 'backbone_lr': 1e-4},
    'rmsprop_eps_outside': {'type': 'rmsprop', 'lr': 1e-3, 'eps_in_sqrt': False,
                            'initial_scale': 0.1, 'bias_correction': True, 'momentum': 0.5},
}
OPTAX_UPDATES = 5
OPTAX_RTOL = 1e-6


def _optax_faults(opt_cfg: dict, grad_clip) -> list:
    want, got, init, _ = _run(opt_cfg, updates=OPTAX_UPDATES, steps_per_epoch=1,
                              grad_clip=grad_clip)
    bad = []
    for k in SHAPES:
        assert not np.array_equal(want[k], init[k]), k  # every tensor moved
        err, scale = np.abs(got[k] - want[k]).max(), np.abs(want[k]).max()
        if not err <= OPTAX_RTOL * scale:
            bad.append(f'{k}: {err:.3g} > {OPTAX_RTOL:.0e} x {scale:.3g}')
    return bad


@pytest.mark.parametrize('grad_clip', [None, 1.0], ids=['noclip', 'clip'])
@pytest.mark.parametrize('case', sorted(OPTAX_CASES))
def test_optimizers_match_optax(case, grad_clip):
    assert _optax_faults(OPTAX_CASES[case], grad_clip) == []


def test_lamb_decay_mask_matches_optax():
    """Zero gradients: LAMB's update is -lr p on the decayed tensors (trust
    ratio 1 / wd) and nothing elsewhere (a zero update)."""
    want, got, init, _ = _run({'type': 'lamb', 'lr': 1e-3, 'weight_decay': 1e-2},
                              zero_grads=True, updates=OPTAX_UPDATES)
    for k, shape in SHAPES.items():
        assert (not np.array_equal(want[k], init[k])) == (len(shape) > 1), k
        np.testing.assert_allclose(got[k], want[k], atol=1e-8, err_msg=k)


def test_optax_differential_has_teeth(monkeypatch):
    """torch's RMSprop (alpha 0.99, eps outside the root) in place of optax's fails."""
    from slowtv_monodepth_tpu_torch import optim

    def torch_rmsprop(groups, lr, decay=0.9, eps=1e-8, **kw):
        return torch.optim.RMSprop(groups, lr=lr, eps=eps)

    monkeypatch.setitem(optim.OPTIMIZERS, 'rmsprop', torch_rmsprop)
    assert _optax_faults(OPTAX_CASES['rmsprop'], None)


def test_dtype_options_raise():
    module = Params({'a': np.zeros(2, np.float32)})
    for cfg in ({'type': 'adam', 'mu_dtype': 'bfloat16'},
                {'type': 'sgd', 'momentum': 0.9, 'accumulator_dtype': 'bfloat16'}):
        with pytest.raises(NotImplementedError, match='queue A item 14'):
            parsers.get_opt(cfg, module)
    with pytest.raises(KeyError, match='Unknown optimizer options'):
        parsers.get_opt({'type': 'adam', 'weight_decay': 1e-2}, module)
