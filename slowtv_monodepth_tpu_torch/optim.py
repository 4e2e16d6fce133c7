"""The optax update rules the JAX package's `parsers.get_opt` builds, as torch optimizers.

optax 0.2.6's `adam`, `sgd`, `lamb`, `adabelief` and `rmsprop`, with their
argument names and defaults, written out in their own order of float32
operations (`scale_by_adam`, `trace`, `add_decayed_weights`,
`scale_by_trust_ratio`, `scale_by_belief`, `scale_by_rms`,
`scale_by_stddev`, `scale_by_learning_rate`). torch's built-ins differ
where it shows: `RMSprop` decays by 0.99 and adds eps outside the root, and
torch has no LAMB and no AdaBelief. The bias corrections `1 - b**count` are
computed in float32, as optax computes them.

Each is stepped by `parsers.Optimizer` once per update, with the group's LR
already set to the schedule's; the update count lives in each param group
(`count`), so `state_dict()` carries it. `adamw` stays torch's `Adam` plus
the decoupled decay in `parsers.Optimizer`, which reads a group's `decay`:
so RMSprop keeps its `decay` in its groups as `rms_decay`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ['Adam', 'SGD', 'Lamb', 'AdaBelief', 'RMSprop', 'OPTIMIZERS']


def _bias_correction(decay: float, count: int) -> float:
    """optax's `1 - decay**count` in float32."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _ema(moments: list, values: list, decay: float) -> None:
    """moments <- (1 - decay) * values + decay * moments (optax's `update_moment`)."""
    new = torch._foreach_mul(values, 1 - decay)
    torch._foreach_mul_(moments, decay)
    torch._foreach_add_(moments, new)


def _trace(bufs: list, updates: list, decay: float, nesterov: bool) -> list:
    """optax's `trace`: bufs <- updates + decay * bufs; -> the new updates."""
    torch._foreach_mul_(bufs, decay)
    torch._foreach_add_(bufs, updates)
    if not nesterov:
        return [b.clone() for b in bufs]
    out = torch._foreach_mul(bufs, decay)
    torch._foreach_add_(out, updates)
    return out


class _Optax(torch.optim.Optimizer):
    """Shared step: `updates(group, params, grads)` -> the unscaled updates;
    then optax's `scale_by_learning_rate` (times -lr) and `apply_updates`."""

    def __init__(self, params, lr: float, **defaults):
        super().__init__(params, dict(lr=lr, count=0, **defaults))

    def _state(self, p: torch.Tensor, **init) -> dict:
        """The parameter's state, made at its first update (zeros unless `init` says)."""
        st = self.state[p]
        for k, fill in init.items():
            if k not in st:
                st[k] = torch.full_like(p, fill, memory_format=torch.preserve_format)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group['params'] if p.grad is not None]
            if not params:
                continue
            group['count'] += 1
            upd = self.updates(group, params, [p.grad for p in params])
            torch._foreach_mul_(upd, -group['lr'])
            upd = self.after_lr(group, params, upd)
            torch._foreach_add_(params, upd)

    def updates(self, group: dict, params: list, grads: list) -> list:
        raise NotImplementedError

    def after_lr(self, group: dict, params: list, upd: list) -> list:
        return upd


class Adam(_Optax):
    """optax `adam(b1, b2, eps, eps_root, nesterov)` (`scale_by_adam`)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, nesterov: bool = False, **kw):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         nesterov=nesterov, **kw)

    @staticmethod
    def _mu_hat(group: dict, mu: list, grads: list) -> list:
        b1, n = group['b1'], group['count']
        if not group['nesterov']:
            return torch._foreach_div(mu, _bias_correction(b1, n))
        out = torch._foreach_div(mu, _bias_correction(b1, n + 1))
        torch._foreach_mul_(out, b1)
        g = torch._foreach_div(grads, _bias_correction(b1, n))
        torch._foreach_mul_(g, 1 - b1)
        torch._foreach_add_(out, g)
        return out

    def updates(self, group, params, grads):
        st = [self._state(p, mu=0.0, nu=0.0) for p in params]
        mu, nu = [s['mu'] for s in st], [s['nu'] for s in st]
        _ema(mu, grads, group['b1'])
        _ema(nu, torch._foreach_mul(grads, grads), group['b2'])
        denom = torch._foreach_div(nu, _bias_correction(group['b2'], group['count']))
        torch._foreach_add_(denom, group['eps_root'])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group['eps'])
        return torch._foreach_div(self._mu_hat(group, mu, grads), denom)


class Lamb(Adam):
    """optax `lamb(b1, b2, eps=1e-6, eps_root, weight_decay)`: Adam's moments,
    the group's decoupled decay (`weight_decay`: the mask is the grouping), a
    per-tensor trust ratio |p| / |u| (1 where either norm is 0)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 eps_root: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         weight_decay=weight_decay)

    def updates(self, group, params, grads):
        upd = super().updates(group, params, grads)
        if group['weight_decay']:
            torch._foreach_add_(upd, torch._foreach_mul(params, group['weight_decay']))
        p_norm = torch._foreach_norm(params)
        u_norm = torch._foreach_norm(upd)
        ratio = [torch.where((a == 0) | (b == 0), torch.ones_like(a), a / b)
                 for a, b in zip(p_norm, u_norm)]
        torch._foreach_mul_(upd, ratio)
        return upd


class AdaBelief(Adam):
    """optax `adabelief(b1, b2, eps=1e-16, eps_root=1e-16, nesterov)`
    (`scale_by_belief`: the second moment of g - mu, plus eps_root every update)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-16,
                 eps_root: float = 1e-16, nesterov: bool = False):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root, nesterov=nesterov)

    def updates(self, group, params, grads):
        b1, b2, n = group['b1'], group['b2'], group['count']
        st = [self._state(p, mu=0.0, nu=0.0) for p in params]
        mu, nu = [s['mu'] for s in st], [s['nu'] for s in st]
        _ema(mu, grads, b1)
        err = torch._foreach_sub(grads, mu)
        _ema(nu, torch._foreach_mul(err, err), b2)
        torch._foreach_add_(nu, group['eps_root'])
        denom = torch._foreach_div(nu, _bias_correction(b2, n))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group['eps'])
        return torch._foreach_div(self._mu_hat(group, mu, grads), denom)


class SGD(_Optax):
    """optax `sgd(momentum=None, nesterov)`: the momentum trace before the LR."""

    def __init__(self, params, lr: float, momentum: Optional[float] = None, nesterov: bool = False):
        super().__init__(params, lr, momentum=momentum, nesterov=nesterov)

    def updates(self, group, params, grads):
        if group['momentum'] is None:
            return [g.clone() for g in grads]
        bufs = [self._state(p, trace=0.0)['trace'] for p in params]
        return _trace(bufs, grads, group['momentum'], group['nesterov'])


class RMSprop(_Optax):
    """optax `rmsprop(decay=0.9, eps=1e-8, initial_scale, eps_in_sqrt=True,
    centered, momentum, nesterov, bias_correction)`: g * rsqrt(nu + eps)
    (`scale_by_rms`, or `scale_by_stddev` when centered), the LR, then the
    momentum trace."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, eps_in_sqrt: bool = True, centered: bool = False,
                 momentum: Optional[float] = None, nesterov: bool = False,
                 bias_correction: bool = False):
        super().__init__(params, lr, rms_decay=decay, eps=eps, initial_scale=initial_scale,
                         eps_in_sqrt=eps_in_sqrt, centered=centered, momentum=momentum,
                         nesterov=nesterov, bias_correction=bias_correction)

    def updates(self, group, params, grads):
        d, n = group['rms_decay'], group['count']
        init = {'nu': group['initial_scale']} | ({'mu': 0.0} if group['centered'] else {})
        st = [self._state(p, **init) for p in params]
        nu = [s['nu'] for s in st]
        _ema(nu, torch._foreach_mul(grads, grads), d)
        if group['bias_correction']:
            nu = torch._foreach_div(nu, _bias_correction(d, n))
        if group['centered']:
            mu = [s['mu'] for s in st]
            _ema(mu, grads, d)
            if group['bias_correction']:
                mu = torch._foreach_div(mu, _bias_correction(d, n))
            nu = torch._foreach_sub(nu, torch._foreach_mul(mu, mu))
        if group['eps_in_sqrt']:
            scale = torch._foreach_add(nu, group['eps'])
            torch._foreach_rsqrt_(scale)
        else:
            scale = torch._foreach_sqrt(nu)
            torch._foreach_add_(scale, group['eps'])
            torch._foreach_reciprocal_(scale)
        return torch._foreach_mul(scale, grads)

    def after_lr(self, group, params, upd):
        if group['momentum'] is None:
            return upd
        bufs = [self._state(p, trace=0.0)['trace'] for p in params]
        return _trace(bufs, upd, group['momentum'], group['nesterov'])


OPTIMIZERS = {'adam': Adam, 'sgd': SGD, 'lamb': Lamb, 'adabelief': AdaBelief,
              'rmsprop': RMSprop}
