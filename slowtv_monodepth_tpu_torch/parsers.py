"""Config-dict -> nets, losses and optimizer (PyTorch port).

Counterpart of `slowtv_monodepth_tpu/parsers.py` for the ported keys:
- `get_net`: `depth` (`DepthNet`) and `pose` (`PoseNet`);
- `get_ds` / `get_dl`: the registered datasets (`data/`: every key of the
  JAX package's registry; an unknown one raises `KeyError`) behind the
  prefetching loader, one loader per dataset, interleaved round-robin;
- `get_loss`: `img_recon` (`ReconstructionLoss`), `depth_regr` and
  `stereo_const` (`RegressionLoss`), `disp_smooth` (`SmoothReg`), `disp_occ`
  (`OccReg`) and `disp_mask` (`MaskReg`), with their static weights; the
  feature losses raise `NotImplementedError` naming ROADMAP A9b, an unknown
  key `KeyError`;
- `get_sched`: the product of the configured epoch factors, evaluated at
  `update // steps_per_epoch`;
- `get_opt` / `make_optimizer`: AdamW, Adam, SGD, LAMB, AdaBelief or
  RMSprop (optax's definitions, `optim.py`) as an `Optimizer` that is
  stepped once per micro-step and averages the gradients over `accumulate`
  micro-steps, with the schedule counting optimizer updates
  (`optax.MultiSteps` semantics), optional clipping of the averaged
  gradient by its global norm, the loop's LR scale and `frozen_bn`.
Other keys raise `NotImplementedError` naming the ROADMAP item that ports
them. Torch optimizers hold their parameters, so `get_opt` and
`make_optimizer` take the nets as their second argument.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from .core.schedules import SCHEDULES
from .losses import MaskReg, OccReg, ReconstructionLoss, RegressionLoss, SmoothReg
from .models import DepthNet, PoseNet
from .optim import OPTIMIZERS

__all__ = ['get_net', 'get_loss', 'get_ds', 'get_dl', 'get_sched', 'get_opt',
           'make_optimizer', 'Optimizer', 'bn_params']

NETS = {'depth': DepthNet, 'pose': PoseNet}
LOSSES = {'img_recon': ReconstructionLoss, 'depth_regr': RegressionLoss,
          'stereo_const': RegressionLoss, 'disp_smooth': SmoothReg, 'disp_occ': OccReg,
          'disp_mask': MaskReg}
# The Depth-VO-Feat and FeatDepth recipes' nets and losses (ROADMAP A9b).
A9B_NETS = ('autoencoder',)
A9B_LOSSES = ('feat_recon', 'autoenc_recon', 'feat_peaky', 'feat_smooth')


def _listify(v):
    return tuple(v) if isinstance(v, list) else v


def get_net(cfg: dict, **kw) -> nn.ModuleDict:
    """Nets of the cfg `net` section (`~` deletes one). `kw` goes to every net
    (`kernels`)."""
    nets = {}
    for k, net_kw in cfg.items():
        if net_kw is None:
            continue
        if k in A9B_NETS:
            raise NotImplementedError(f'Net "{k}" is not ported yet (have {sorted(NETS)}); '
                                      'ROADMAP queue A item 9b.')
        if k not in NETS:
            raise KeyError(f'Unknown network "{k}". ({sorted(NETS)})')
        nets[k] = NETS[k](**{key: _listify(v) for key, v in net_kw.items()}, **kw)
    return nn.ModuleDict(nets)


def get_loss(cfg: dict, **kw) -> tuple[dict, dict]:
    """Losses + static weights of the cfg `loss` section; `kw` (`kernels`)
    goes to the reconstruction loss."""
    losses, weights = {}, {}
    for k, loss_kw in cfg.items():
        if loss_kw is None:
            continue
        if k in A9B_LOSSES:
            raise NotImplementedError(f'Loss "{k}" is not ported yet (have {sorted(LOSSES)}); '
                                      'ROADMAP queue A item 9b.')
        if k not in LOSSES:
            raise KeyError(f'Unknown loss "{k}". ({sorted(LOSSES)})')
        loss_kw = dict(loss_kw)
        weights[k] = float(loss_kw.pop('weight', 1.0))
        losses[k] = LOSSES[k](**loss_kw, **(kw if k == 'img_recon' else {}))
    return losses, weights


_MODES = {'train', 'val', 'test'}


def get_ds(cfg: dict, mode: Optional[str] = None) -> dict:
    """Datasets of the cfg `dataset` section, with the mode's overrides merged in."""
    from .registry import DATA_REG, trigger_datasets
    trigger_datasets()
    ds = {}
    for t, kw in cfg.items():
        if kw is None:
            continue
        if not isinstance(kw, dict):
            raise TypeError(f"Expected dict of dicts. Got '{kw}'.")
        if t not in DATA_REG:
            raise KeyError(f'Unknown dataset "{t}". ({sorted(DATA_REG)})')
        c = {k: v for k, v in kw.items() if k not in _MODES}
        if mode:
            c.update(kw.get(mode, {}))
        ds[t] = DATA_REG[t](**c)
    return ds


def get_dl(mode: str, cfg_ds: dict, cfg_dl: dict, shard_id: int = 0, num_shards: int = 1):
    """The (multi-)dataset loader of a mode. Several datasets interleave
    through `ConcatDataLoader` (every batch comes from one dataset: shapes
    differ between them), each seeded `seed * 10**i`."""
    from .data import ConcatDataLoader, DataLoader
    datasets = list(get_ds(cfg_ds, mode).values())
    if not datasets:
        raise ValueError('No datasets configured.')

    cfg = {k: v for k, v in cfg_dl.items() if k not in _MODES} | (cfg_dl.get(mode) or {})
    cfg.pop('pin_memory', None)
    cfg.pop('use_ddp', None)
    seed = cfg.pop('seed', 42)

    dls = [DataLoader(d, seed=seed * 10 ** i, shard_id=shard_id, num_shards=num_shards, **cfg)
           for i, d in enumerate(datasets)]
    return dls[0] if len(dls) == 1 else ConcatDataLoader(dls)


def get_sched(cfg: Optional[dict], steps_per_epoch: int) -> Callable[[int], float]:
    """-> factor(update): the product of the configured epoch factors."""
    factors = []
    for k, kw in (cfg or {}).items():
        if kw is None:
            continue
        if k not in SCHEDULES:
            raise KeyError(f'Unknown scheduler "{k}". ({sorted(SCHEDULES)})')
        factors.append(SCHEDULES[k](**kw))

    def factor(update: int) -> float:
        epoch = update // max(steps_per_epoch, 1)
        out = 1.0
        for f in factors:
            out *= f(epoch)
        return out
    return factor


class Optimizer:
    """A torch optimizer stepped once per micro-step.

    Every `accumulate`-th call of `step` averages the gradients the
    micro-steps' backward passes summed into `.grad`, sets each group's LR
    to its base LR times the schedule at the update count, applies the group's
    decoupled weight decay (`decay`, AdamW only: `p -= lr * wd * p`, as
    optax's `adamw`; torch's AdamW multiplies by `1 - lr * wd` rounded to
    float32, which is 1% off at lr * wd = 1e-6), steps the inner optimizer
    and clears the gradients.
    Other calls leave the parameters as they are, as `optax.MultiSteps`
    emits zero updates. `grad_clip` scales the averaged gradient down to
    that global norm first (`optax.clip_by_global_norm` inside MultiSteps).
    Then the gradients of the `frozen` parameters are zeroed (`frozen_bn`:
    the JAX package's `optax.set_to_zero` between the clip and the optimizer,
    so the clip's norm still counts them, and a decoupled decay still applies).

    `state_dict` / `load_state_dict` carry the inner optimizer's state (Adam's
    moments and step counts, ...), the update and micro-step counters and,
    between two updates, the gradients accumulated so far.
    """

    def __init__(self, opt: torch.optim.Optimizer, sched: Callable[[int], float],
                 accumulate: int = 1, grad_clip: Optional[float] = None, frozen=()):
        self.opt = opt
        self.sched = sched
        self.accumulate = max(int(accumulate), 1)
        self.grad_clip = grad_clip
        self.frozen = list(frozen)
        self.base_lrs = [g['lr'] for g in opt.param_groups]
        self.updates = 0
        self.micro = 0

    def lrs(self) -> list[float]:
        """Each group's LR for the next update."""
        f = self.sched(self.updates)
        return [lr * f for lr in self.base_lrs]

    @torch.no_grad()
    def step(self) -> bool:
        """Account one micro-step; -> True when it made an update."""
        self.micro += 1
        if self.micro < self.accumulate:
            return False
        grads = [p.grad for p in self.params() if p.grad is not None]
        if self.accumulate > 1:
            torch._foreach_mul_(grads, 1.0 / self.accumulate)
        if self.grad_clip:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, self.grad_clip / torch.clamp(norm, min=self.grad_clip))
        for p in self.frozen:
            if p.grad is not None:
                p.grad.zero_()
        for group, lr in zip(self.opt.param_groups, self.lrs()):
            group['lr'] = lr
            if group.get('decay'):  # AdamW's decoupled decay
                torch._foreach_add_(group['params'], group['params'], alpha=-lr * group['decay'])
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.updates += 1
        self.micro = 0
        return True

    def params(self) -> list:
        """The parameters, in the groups' order."""
        return [p for g in self.opt.param_groups for p in g['params']]

    def state_dict(self) -> dict:
        grads = [p.grad for p in self.params()] if self.micro else None
        return {'opt': self.opt.state_dict(), 'updates': self.updates, 'micro': self.micro,
                'grads': grads}

    def load_state_dict(self, sd: dict) -> None:
        self.opt.load_state_dict(sd['opt'])
        self.updates, self.micro = int(sd['updates']), int(sd['micro'])
        for p, g in zip(self.params(), sd['grads'] or [None] * len(self.params())):
            p.grad = None if g is None else g.to(p.device, p.dtype).clone()


def _has(name: str, key: str) -> bool:
    return any(key in part for part in name.split('.'))


def bn_params(nets: nn.Module) -> list:
    """The BatchNorm affine parameters (`frozen_bn`'s set). The JAX package picks
    them by the substring `bn` in its names (`bn1`, `downsample_bn`); under timm's
    names the downsample's BatchNorm is `downsample.1`, so the port picks by type."""
    return [p for m in nets.modules() if isinstance(m, nn.BatchNorm2d)
            for p in m.parameters(recurse=False) if p.requires_grad]


# optax's options of each optimizer (the cfg passes them through by name).
_OPT_OPTIONS = {'adamw': ('b1', 'b2', 'eps', 'weight_decay'),
                'adam': ('b1', 'b2', 'eps', 'eps_root', 'nesterov'),
                'sgd': ('momentum', 'nesterov'),
                'lamb': ('b1', 'b2', 'eps', 'eps_root', 'weight_decay'),
                'adabelief': ('b1', 'b2', 'eps', 'eps_root', 'nesterov'),
                'rmsprop': ('decay', 'eps', 'initial_scale', 'eps_in_sqrt', 'centered',
                            'momentum', 'nesterov', 'bias_correction')}


def get_opt(cfg: dict, nets: nn.Module, steps_per_epoch: int = 1,
            sched_cfg: Optional[dict] = None, accumulate: int = 1, lr_scale: float = 1.0,
            grad_clip: Optional[float] = None) -> Optimizer:
    """The optimizer of the cfg `optimizer` section over `nets`' parameters:
    `type` one of adamw, adam, sgd, lamb, adabelief, rmsprop, with optax's
    option names and defaults.

    - adamw and lamb with one LR and `weight_decay` set: decay only
      parameters with ndim > 1 (timm's `filter_bias_and_bn`, which the JAX
      package mirrors). adamw without `weight_decay` decays everything by
      optax's default 1e-4; lamb's default is 0.
    - `backbone_lr`: parameters under an `encoder` take it, the rest `lr`,
      and the decay applies to all of them (no filter, as the reference).
    - `lr_scale` multiplies both LRs (the loop's `auto_scale_lr`).
    - `frozen_bn`: the BatchNorm affine parameters' gradients are zeroed before
      each update (`bn_params`); their running statistics still update.
    """
    cfg = dict(cfg)
    name = cfg.pop('type', cfg.pop('opt', None))
    if name is None:
        raise KeyError('Must provide an optimizer `type`.')
    if name not in _OPT_OPTIONS:
        raise KeyError(f'Unknown optimizer "{name}". ({sorted(_OPT_OPTIONS)})')
    frozen = bn_params(nets) if cfg.pop('frozen_bn', False) else []
    if cfg.pop('flatten', False):
        raise NotImplementedError('flatten (a TPU option) is not ported.')
    for key in ('mu_dtype', 'accumulator_dtype'):
        if cfg.pop(key, None) is not None:
            raise NotImplementedError(f'{key} (optimizer state in another dtype) is not ported '
                                      '(ROADMAP queue A item 14).')
    lr = float(cfg.pop('lr', 1e-3)) * lr_scale
    blr = cfg.pop('backbone_lr', None)
    kw = {k: cfg.pop(k) for k in _OPT_OPTIONS[name] if k in cfg}
    if cfg:
        raise KeyError(f'Unknown optimizer options {sorted(cfg)} for "{name}" '
                       f'(optax: {_OPT_OPTIONS[name]})')
    wd_cfg = kw.pop('weight_decay', None)
    # optax.adamw's default decay applies when the cfg gives none (unmasked).
    wd = (1e-4 if name == 'adamw' else 0.0) if wd_cfg is None else float(wd_cfg)
    # The group key of the decay: AdamW's is `Optimizer.step`'s (decoupled), LAMB's
    # its own update's (before the trust ratio); the others take none.
    decay_key = {'adamw': 'decay', 'lamb': 'weight_decay'}.get(name)
    named = [(n, p) for n, p in nets.named_parameters() if p.requires_grad]

    def group(params: list, decay: float, **kw) -> dict:
        return {'params': params, **kw, **({decay_key: decay} if decay_key else {})}

    if blr:
        blr = float(blr) * lr_scale
        if blr == lr:
            raise ValueError('Backbone LR must be different from the main LR')
        groups = [group([p for n, p in named if _has(n, 'encoder')], wd, lr=blr),
                  group([p for n, p in named if not _has(n, 'encoder')], wd, lr=lr)]
        groups = [g for g in groups if g['params']]
    elif wd_cfg:
        groups = [group([p for _, p in named if p.ndim > 1], wd),
                  group([p for _, p in named if p.ndim <= 1], 0.0)]
    else:
        groups = [group([p for _, p in named], wd)]
    if name == 'adamw':  # Adam's moments from torch
        opt = torch.optim.Adam(groups, lr=lr, weight_decay=0.0,
                               betas=(kw.get('b1', 0.9), kw.get('b2', 0.999)),
                               eps=kw.get('eps', 1e-8))
    else:
        opt = OPTIMIZERS[name](groups, lr=lr, **kw)
    return Optimizer(opt, get_sched(sched_cfg, steps_per_epoch), accumulate, grad_clip, frozen)


def make_optimizer(cfg: dict, nets: nn.Module, steps_per_epoch: int = 1,
                   accumulate: int = 1, lr_scale: float = 1.0,
                   grad_clip: Optional[float] = None) -> Optimizer:
    """The training optimizer of a full cfg: clip -> AdamW under the cfg's
    schedule -> gradient accumulation."""
    return get_opt(cfg.get('optimizer', {}), nets, steps_per_epoch, cfg.get('scheduler'),
                   accumulate=accumulate, lr_scale=lr_scale, grad_clip=grad_clip)
