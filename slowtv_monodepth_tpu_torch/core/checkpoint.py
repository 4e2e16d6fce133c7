"""Checkpoints in the reference's Lightning layout, with the best/last policy.

A file holds `{'state_dict': {'nets.depth.<key>': tensor, ...},
'hyper_parameters': {'cfg': cfg}}`: what the reference saves, what
`api/data/import_reference_ckpt.py` (JAX package) reads, and what
`load_checkpoint` here reads, so released reference checkpoints load as
they are. The JAX package's own orbax checkpoints come across through
`models.from_jax` (see that module) and `train_state_from_jax`.

A TRAINING checkpoint is the same file with more keys beside those two, so
`BenchmarkPredictor.load_model` serves it unchanged: `optimizer` (Adam's
moments and step counts, the update and micro-step counters, gradients
accumulated between two updates), `epoch`, `global_step` and `monitor`.
`restore_checkpoint` puts them back into the nets and the optimizer.

Counterpart of `slowtv_monodepth_tpu/core/checkpoint.py` for the policy:
`<ckpt_dir>/last.ckpt` every epoch, `<ckpt_dir>/best.ckpt` when the monitored
value improves (max-mode iff the name contains 'Acc'), each with a
`<name>.json` beside it holding {epoch, step, monitor}.

Asynchronous saves (`CheckpointManager(async_save=True)`, the loop's
`trainer.async_ckpt`): the save snapshots the whole state on its device
(clones of every net and optimizer tensor; `state_dict()` returns LIVE
tensors, which the next `opt.step()` overwrites in place), records a CUDA
event after the clones and returns; an `AsyncSaver` thread waits for the
event, copies the snapshot to the host and writes the files while training
goes on. One save is in flight at most: the next one joins it first, and a
failure in the thread raises at the next save or at `finalize()`. The files
are the synchronous save's, tensors on the host.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from .. import LOGGER

__all__ = ['save_checkpoint', 'load_checkpoint', 'net_state_dict', 'load_net',
           'restore_checkpoint', 'get_latest_ckpt', 'CheckpointManager', 'AsyncSaver',
           'train_state_from_jax']


def _checkpoint(nets: Mapping[str, Mapping[str, torch.Tensor]], cfg: dict, opt=None,
                epoch: int = 0, step: int = 0, monitor: Optional[float] = None) -> dict:
    """The file's contents; net tensors detached where they are, optimizer
    state as `opt.state_dict()` gives it (live tensors)."""
    ckpt = {'state_dict': {f'nets.{name}.{k}': v.detach()
                           for name, net_sd in nets.items() for k, v in net_sd.items()},
            'hyper_parameters': {'cfg': cfg}}
    if opt is not None:
        ckpt.update(optimizer=opt.state_dict(), epoch=int(epoch), global_step=int(step),
                    monitor=None if monitor is None else float(monitor))
    return ckpt


def _write(path, ckpt: dict) -> None:
    """`ckpt` (net tensors on the host) -> `path`, and a training checkpoint's
    {epoch, step, monitor} -> `<path stem>.json`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if 'optimizer' in ckpt:
        meta = {'epoch': ckpt['epoch'], 'step': ckpt['global_step'], 'monitor': ckpt['monitor']}
        path.with_suffix('.json').write_text(json.dumps(meta))
    torch.save(ckpt, path)


def _map_tensors(tree, fn):
    """`tree` (dicts, lists, tuples) with `fn` applied to every tensor, every
    container rebuilt."""
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(path, nets: Mapping[str, Mapping[str, torch.Tensor]], cfg: dict,
                    opt=None, epoch: int = 0, step: int = 0,
                    monitor: Optional[float] = None) -> None:
    """:param nets: net name ('depth', ...) -> that net's `state_dict()`.
    :param opt: the `parsers.Optimizer` of a training run; with it the file
        also carries the optimizer state, `epoch`, `global_step` and `monitor`,
        and `<path stem>.json` repeats the three numbers.
    """
    ckpt = _checkpoint(nets, cfg, opt, epoch, step, monitor)
    ckpt['state_dict'] = {k: v.cpu() for k, v in ckpt['state_dict'].items()}
    _write(path, ckpt)


class AsyncSaver:
    """One-slot background writer: at most one save in flight; `submit` joins
    the previous save first, `wait` re-raises a failure of the background save."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def submit(self, fn: Callable[[], None]) -> None:
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - raised by the next wait()
                self._exc = e

        self._thread = threading.Thread(target=run, daemon=True, name='ckpt-saver')
        self._thread.start()


def snapshot(ckpt: dict):
    """-> (copy of `ckpt` with every tensor cloned on its device, the CUDA
    event after the clones or None). The clones are the state at this point of
    the stream, whatever runs after."""
    snap = _map_tensors(ckpt, lambda t: t.detach().clone())
    device = _cuda_device(snap)
    event = None
    if device is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return snap, event


def _cuda_device(tree) -> Optional[torch.device]:
    """The device of the first CUDA tensor of `tree`, if it holds one."""
    tensors = []
    _map_tensors(tree, tensors.append)
    return next((t.device for t in tensors if t.is_cuda), None)


def write_snapshot(files: list, snap: dict, event: Optional[torch.cuda.Event]) -> None:
    """The background half: wait for the clones, copy them to the host on a
    stream of this thread's own, write `snap` to each of `files`."""
    if event is not None:
        event.synchronize()
        with torch.cuda.stream(torch.cuda.Stream(_cuda_device(snap))):
            snap = _map_tensors(snap, lambda t: t.cpu())
    for path, monitor in files:
        ckpt = dict(snap)
        if 'optimizer' in ckpt:
            ckpt['monitor'] = monitor
        _write(path, ckpt)


def load_checkpoint(path) -> tuple[dict[str, torch.Tensor], dict]:
    """-> (full state dict with `nets.*` keys, cfg)."""
    ckpt = torch.load(Path(path), map_location='cpu', weights_only=False)
    return ckpt['state_dict'], dict(ckpt.get('hyper_parameters', {}).get('cfg', {}))


def net_state_dict(sd: Mapping[str, torch.Tensor], name: str) -> dict:
    """The `nets.<name>.` sub-dict with the prefix stripped."""
    pre = f'nets.{name}.'
    out = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    if not out:
        raise ValueError(f'No "{pre}*" weights in the checkpoint.')
    return out


def load_net(net: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """`net.load_state_dict(sd)`, strict, after dropping the keys a reference
    checkpoint holds and its forward never uses (`net.unused_reference_keys()`,
    a `DepthNet`'s: HR-Depth's row-0 `conv_0`s, DiffNet's out convs outside
    `out_sc`, DDV-Net's `bins`). Every other missing or unexpected key raises."""
    unused = set(getattr(net, 'unused_reference_keys', list)())
    net.load_state_dict({k: v for k, v in sd.items() if k not in unused})


def restore_checkpoint(path, nets: Mapping[str, torch.nn.Module], opt=None) -> dict:
    """Load a checkpoint's weights into `nets` and, with `opt`, its optimizer
    state into `opt` when the file has one -> {epoch, step, monitor, cfg,
    optimizer (whether the file had optimizer state)}."""
    ckpt = torch.load(Path(path), map_location='cpu', weights_only=False)
    for name, net in nets.items():
        load_net(net, net_state_dict(ckpt['state_dict'], name))
    if opt is not None and 'optimizer' in ckpt:
        opt.load_state_dict(ckpt['optimizer'])
    return {'epoch': ckpt.get('epoch', -1), 'step': ckpt.get('global_step', 0),
            'monitor': ckpt.get('monitor'), 'optimizer': 'optimizer' in ckpt,
            'cfg': dict(ckpt.get('hyper_parameters', {}).get('cfg', {}))}


def get_latest_ckpt(ckpt_dir) -> Optional[Path]:
    """The last checkpoint of a run directory, if there is one."""
    last = Path(ckpt_dir) / 'last.ckpt'
    return last if last.is_file() else None


class CheckpointManager:
    """best/last policy around `save_checkpoint`.

    :param ckpt_dir: run checkpoint directory.
    :param monitor: metric name to track for `best` (e.g. 'AbsRel', 'loss').
    :param mode: 'min'/'max'/None; None infers max iff 'Acc' is in the name.
    :param async_save: snapshot on the device and write in the background
        (`AsyncSaver`); `finalize()` waits for the last write.
    """

    def __init__(self, ckpt_dir, monitor: str = 'loss', mode: Optional[str] = None,
                 async_save: bool = False):
        self.ckpt_dir = Path(ckpt_dir)
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode or ('max' if 'Acc' in monitor else 'min')
        self.best: Optional[float] = None
        self.saver = AsyncSaver() if async_save else None

    def is_better(self, value: float) -> bool:
        if self.best is None:
            return True
        return value > self.best if self.mode == 'max' else value < self.best

    def step(self, nets: Mapping[str, torch.nn.Module], opt, cfg: dict, epoch: int,
             step: int, metrics: dict) -> None:
        """End-of-epoch hook: always refresh `last`, update `best` on improvement.
        Asynchronous: both files from one snapshot, written by one background save."""
        sds = {k: net.state_dict() for k, net in nets.items()}
        value = metrics.get(self.monitor)
        files = [(self.ckpt_dir / 'last.ckpt', value)]
        if value is not None and self.is_better(float(value)):
            self.best = float(value)
            LOGGER.info(f'New best {self.monitor}={self.best:.4f} @ epoch {epoch}')
            files.append((self.ckpt_dir / 'best.ckpt', self.best))
        if self.saver is None:
            for path, monitor in files:
                save_checkpoint(path, sds, cfg, opt, epoch, step, monitor)
            return
        self.saver.wait()  # the previous write first: one snapshot on the device at a time
        snap, event = snapshot(_checkpoint(sds, cfg, opt, epoch, step, value))
        self.saver.submit(lambda: write_snapshot(files, snap, event))

    def finalize(self) -> None:
        """Wait for the save in flight; raise its failure, if it failed."""
        if self.saver is not None:
            self.saver.wait()

    def restore_best_value(self) -> None:
        """Recover the tracked best value after a resume."""
        meta_file = self.ckpt_dir / 'best.json'
        if meta_file.is_file():
            self.best = json.loads(meta_file.read_text()).get('monitor')


def _find_adam(state):
    """The `ScaleByAdamState` (anything with `mu` and `nu`) inside an optax state."""
    if hasattr(state, 'mu') and hasattr(state, 'nu'):
        return state
    children = state if isinstance(state, (tuple, list)) else ()
    if hasattr(state, 'inner_state'):  # optax.MaskedState and friends
        children = (state.inner_state,)
    for child in children:
        if (found := _find_adam(child)) is not None:
            return found
    return None


def train_state_from_jax(state, nets: Mapping[str, torch.nn.Module], opt,
                         out_scales=None) -> int:
    """Carry a JAX-package `TrainState` (leaves as numpy) into the port's nets
    and `parsers.Optimizer`, so both step functions continue from one state.

    :param state: `jax.tree.map(np.asarray, train_state)`: `params` {'depth',
        ['pose'], ['autoencoder']}, `aux` (a BatchNorm net's `batch_stats`: its running statistics
        go into the net's buffers), `step`, and `opt_state` of
        `parsers.make_optimizer`: AdamW,
        bare or under `optax.MultiSteps` (read by attribute: `mu`, `nu`, `count`;
        `mini_step`, `gradient_step`, `acc_grads`, `inner_opt_state`).
    :param out_scales: the depth net's `out_scales` in cfg order.
    :return: the state's micro-step count (`TrainState.step`).

    MultiSteps keeps the running MEAN of the micro-steps' gradients; the port
    keeps their SUM in `.grad`, so the accumulator comes across times `mini_step`.
    """
    from ..models.from_jax import (autoencoder_state_dict_from_jax, depth_state_dict_from_jax,
                                   pose_state_dict_from_jax)
    convert = {'depth': lambda t, stats=None: depth_state_dict_from_jax(t, out_scales, stats),
               'pose': pose_state_dict_from_jax,
               'autoencoder': lambda t, stats=None: autoencoder_state_dict_from_jax(
                   t, nets['autoencoder'].out_sc, stats)}
    if set(nets) - set(convert):
        raise NotImplementedError(f'Nets {sorted(set(nets) - set(convert))} have no bridge.')

    def port_tensors(tree) -> dict:  # parameter (by identity) -> the tree's tensor for it
        out = {}
        for name, net in nets.items():
            sd = convert[name](tree[name])
            for k, p in net.named_parameters():
                out[p] = sd[k].to(p.device, p.dtype).contiguous()
        return out

    ostate = state.opt_state
    multi = hasattr(ostate, 'inner_opt_state')
    adam = _find_adam(ostate.inner_opt_state if multi else ostate)
    if adam is None:
        raise ValueError('No Adam moments (mu, nu) in the optimizer state.')
    if multi != (opt.accumulate > 1):
        raise ValueError('The state and the optimizer disagree on gradient accumulation.')

    with torch.no_grad():
        for p, v in port_tensors(state.params).items():
            p.copy_(v)
        for name, net in nets.items():
            stats = state.aux.get(name, {}).get('batch_stats')
            if stats is None:
                continue
            sd = convert[name](state.params[name], stats)
            for k, b in net.named_buffers():
                b.copy_(sd[k])
    mu, nu = port_tensors(adam.mu), port_tensors(adam.nu)
    count = int(np.asarray(adam.count))
    for p in opt.params():
        opt.opt.state[p] = {'step': torch.tensor(float(count)), 'exp_avg': mu[p].clone(),
                            'exp_avg_sq': nu[p].clone()}
    opt.updates = int(np.asarray(ostate.gradient_step)) if multi else count
    opt.micro = int(np.asarray(ostate.mini_step)) if multi else 0
    acc = port_tensors(ostate.acc_grads) if opt.micro else {}
    for p in opt.params():
        p.grad = acc[p] * opt.micro if opt.micro else None
    return int(np.asarray(state.step))
