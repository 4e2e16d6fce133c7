"""Training loop runner: the imperative shell around the training step (PyTorch port).

Counterpart of `slowtv_monodepth_tpu/core/loop.py` on one device:

- epoch iteration over the (multi-dataset round-robin) host loader,
- batch placement on the device, with the net inputs derived there when the
  dataset ships only the raw images (`device_transform`),
- KBR aspect-ratio augmentation per batch (the host samples the bucketed
  shape, the device resamples through the warp kernel),
- scalar logging every `log_every_n_steps` (host sync only at log steps),
- non-finite-loss detection at sync points (the step's `bad_step` tripwire),
- validation on the loss, best/last checkpoints + resume (`resume_training`),
- `TrainingManager` marker files (training_<epoch>_<host> / finished) so runs
  can't double-start and eval scripts can trust completed checkpoints,
- LR scaling by the gradient accumulation (`auto_scale_lr`), SWA and early
  stopping,
- the image logger (`heavy_logger`) on the epoch's last training batch, when
  the writer takes images,
- asynchronous checkpoint saves (`trainer.async_ckpt`: the save snapshots the
  state on the device and writes it while the next epoch trains).

Not ported, each raising `NotImplementedError`: device meshes, ZeRO and
spatial sharding (ROADMAP A11), profiler traces (`trainer.profile_dir`,
A12). `trainer.precompile_buckets` is accepted and does nothing: eager
PyTorch has no compile step to front-load.
"""
from __future__ import annotations

import math
import random as _random
import signal
import socket
from functools import partial
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import LOGGER, parsers
from ..utils import MultiLevelTimer, flatten_dict
from .aspect_ratio import aspect_ratio_aug
from .checkpoint import CheckpointManager, get_latest_ckpt, restore_checkpoint, save_checkpoint
from .device_transform import derive_batch, needs_derive
from .trainer import MonoDepthTrainer

__all__ = ['MonoDepthLoop', 'TrainingManager']

_PHOTO_KEYS = ('photo_order', 'photo_factors', 'photo_on')


class TrainingManager:
    """Run marker files + SIGTERM cleanup."""

    def __init__(self, ckpt_dir):
        self.ckpt_dir = Path(ckpt_dir)
        self.ckpt_dir.mkdir(exist_ok=True, parents=True)
        self.host = socket.gethostname()
        self.ftrain: Optional[Path] = None
        self.fend = self.ckpt_dir / 'finished'

        existing = sorted(self.ckpt_dir.glob('training*'))
        if existing:
            raise ValueError(f'Training already in progress! ({existing[0]})')
        if self.fend.is_file():
            raise ValueError(f'Training already finished! ({self.fend})')
        signal.signal(signal.SIGTERM, self._on_sigterm)

    def on_epoch_start(self, epoch: int) -> None:
        if self.ftrain:
            self.ftrain.unlink(missing_ok=True)
        self.ftrain = self.ckpt_dir / f'training_{epoch}_{self.host}'
        self.ftrain.touch()

    def on_fit_end(self) -> None:
        self.cleanup()
        self.fend.touch()

    def cleanup(self) -> None:
        if self.ftrain:
            self.ftrain.unlink(missing_ok=True)

    def _on_sigterm(self, signum, frame) -> None:
        raise SystemExit


class MonoDepthLoop:
    """:param cfg: full merged YAML cfg (net/loss/dataset/loader/optimizer/
        scheduler/trainer sections).
    :param ckpt_dir: run directory for checkpoints + markers.
    :param device: where the run trains; 'cuda' unless the caller asks for the CPU.
    :param writer: optional scalar logger with `.add_scalar(tag, val, step)`.
    :param train_dl, val_dl: loaders to use instead of `parsers.get_dl` on the
        cfg's `dataset` and `loader` sections (which then need not be there):
        iterables of (x, y, m) host batches with `__len__` and `set_epoch`.
    :param mesh: the JAX loop's device mesh; not ported, anything but None raises.
    :param heavy_logger: a `core.HeavyLogger`, called after each training
        epoch on its last batch when the writer has `add_images`.
    """

    def __init__(self, cfg: dict, ckpt_dir, device='cuda', writer=None,
                 use_markers: bool = True, train_dl=None, val_dl=None, mesh=None,
                 heavy_logger=None):
        self.cfg = cfg
        self.ckpt_dir = Path(ckpt_dir)
        self.device = torch.device(device)
        self.writer = writer

        tcfg = cfg.get('trainer', {})
        for name, given, item in (
                ('mesh', mesh, 'A11'), ('trainer.zero', tcfg.get('zero'), 'A11'),
                ('trainer.profile_dir', tcfg.get('profile_dir'), 'A12')):
            if given:
                raise NotImplementedError(f'{name} is not ported yet (ROADMAP queue A item '
                                          f'{item[1:]}).')
        # `trainer.matmul` is the reference's torch.set_float32_matmul_precision:
        # 'highest' keeps float32 GEMMs, 'high' allows TF32. The setting is
        # process-global; unset leaves it as it is.
        if matmul := tcfg.get('matmul'):
            torch.set_float32_matmul_precision(str(matmul))
        if 'benchmark' in tcfg:
            torch.backends.cudnn.benchmark = bool(tcfg['benchmark'])
        self.max_epochs = tcfg.get('max_epochs', 60)
        self.log_every_n = tcfg.get('log_every_n_steps', 100)
        self.limit_val_batches = tcfg.get('limit_val_batches', 200)
        self.monitor = tcfg.get('monitor', 'AbsRel')
        self.grad_clip = tcfg.get('gradient_clip_val')
        self.accumulate = tcfg.get('accumulate_grad_batches', 1) or 1
        # Optional callbacks: early stopping on the monitored metric, and
        # stochastic weight averaging over the last 25% of epochs (a running
        # sum of the parameters).
        self.early_stopping = tcfg.get('early_stopping')  # None | patience int/True.
        self.use_swa = bool(tcfg.get('swa'))
        self._swa_sum = None
        self._swa_n = 0
        self._es_best = None
        self._es_bad_epochs = 0

        self.ar_aug = partial(
            aspect_ratio_aug,
            p=tcfg.get('aspect_ratio_aug_prob', 0.0),
            crop_min=tcfg.get('aspect_ratio_min', 0.5),
            crop_max=tcfg.get('aspect_ratio_max', 1.0),
            ref_shape=tcfg.get('aspect_ratio_ref_shape'),
        )

        torch.manual_seed(int(cfg.get('seed', 42)))  # the nets' initial weights
        self.trainer = MonoDepthTrainer(cfg).to(self.device)

        self.train_dl = train_dl if train_dl is not None else parsers.get_dl(
            'train', cfg['dataset'], cfg['loader'])
        self.val_dl = val_dl
        if val_dl is None and 'dataset' in cfg:
            try:
                self.val_dl = parsers.get_dl('val', cfg['dataset'], cfg['loader'])
            except (FileNotFoundError, ValueError):
                self.val_dl = None
        LOGGER.info(f'-> Train dataloader: {len(self.train_dl)}')

        lr_scale = self.accumulate if tcfg.get('auto_scale_lr') else 1.0
        steps_per_epoch = max(len(self.train_dl) // self.accumulate, 1)
        self.opt = parsers.make_optimizer(
            cfg, self.trainer.nets, steps_per_epoch=steps_per_epoch, lr_scale=lr_scale,
            grad_clip=self.grad_clip, accumulate=self.accumulate)

        self.ckpt = CheckpointManager(self.ckpt_dir, monitor=self.monitor,
                                      async_save=bool(tcfg.get('async_ckpt', False)))
        self.heavy_logger = heavy_logger
        self.last_batch: Optional[tuple] = None  # the image logger's: ((x, y, m), supp_idxs)
        self.manager = TrainingManager(self.ckpt_dir) if use_markers else None

        self._steps: dict = {}  # (supp_idxs, train) -> step fn.
        self._ready = False
        self.start_epoch = 0
        self.global_step = 0
        # Host wall time per stage of an epoch; with `sync_timers` each stage
        # waits for the device, so the split is true (and the run slower).
        self.sync_timers = False
        self.timer = MultiLevelTimer(name='Loop', as_ms=True, sync_fn=self._sync)

    # ------------------------------------------------------------------ setup
    def _sync(self) -> None:
        if self.sync_timers and self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _step_fn(self, supp_idxs: tuple, train: bool):
        key = (tuple(supp_idxs), train)
        if key not in self._steps:
            self._steps[key] = self.trainer.make_step_fn(supp_idxs, self.opt, train=train)
        return self._steps[key]

    def _init_state(self) -> None:
        """Warm start (`trainer.load_ckpt`) and resume (`trainer.resume_training`)."""
        tcfg = self.cfg.get('trainer', {})
        if load := tcfg.get('load_ckpt'):
            # As the JAX loop (its `core/loop.py:212-215`): the whole state,
            # optimizer included when the file has it, then the step from 0.
            LOGGER.info(f'Warm-starting from {load}...')
            restore_checkpoint(load, self.trainer.nets, self.opt)
            self.trainer.step_count = torch.zeros((), dtype=torch.int64, device=self.device)
            self.trainer.bad_step = torch.full_like(self.trainer.step_count, -1)

        if tcfg.get('resume_training', True):
            if last := get_latest_ckpt(self.ckpt_dir):
                meta = restore_checkpoint(last, self.trainer.nets, self.opt)
                if not meta['optimizer']:
                    raise ValueError(f'"{last}" holds no optimizer state: not a training '
                                     'checkpoint.')
                self.start_epoch = int(meta['epoch']) + 1
                self.global_step = int(meta['step'])
                self.trainer.step_count = torch.tensor(self.global_step, device=self.device)
                self.trainer.bad_step = torch.full_like(self.trainer.step_count, -1)
                self.ckpt.restore_best_value()
                LOGGER.info(f'Resumed from {last} @ epoch {self.start_epoch}')
        self._ready = True

    def _place(self, x: dict, y: dict):
        """Host numpy batch -> device.

        Datasets with `device_transform: true` ship only the raw `y` images;
        the standardized `x` images are recreated here on the device
        (`device_transform.derive_x`) BEFORE the aspect-ratio aug, preserving
        the host pipeline's jiggle -> standardize -> crop order. The sampled
        jiggle parameters stay on the host, where `derive_x` reads them.
        """
        def put(d):
            return {k: (v if k in _PHOTO_KEYS else
                        torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True))
                    for k, v in d.items() if k != 'supp_idxs'}
        xb, yb = put(x), put(y)
        if needs_derive(xb):
            xb, yb = derive_batch(xb, yb)
        return xb, yb

    def step_randomness(self, seed: int) -> dict:
        """The step's random input for this micro-step, as keyword arguments
        of the step function: a generator on the device, seeded by `seed`,
        from which the loss draws its automask tie-break noise."""
        return {'generator': torch.Generator(device=self.device).manual_seed(seed)}

    # ------------------------------------------------------------------- fit
    def fit(self) -> None:
        try:
            if not self._ready:
                self._init_state()
            for epoch in range(self.start_epoch, self.max_epochs):
                if self.manager:
                    self.manager.on_epoch_start(epoch)
                self.train_epoch(epoch)
                metrics = self.val_epoch(epoch) if self.val_dl else {}
                with self.timer('Checkpoint'):
                    self.ckpt.step(self.trainer.nets, self.opt, self.cfg, epoch,
                                   self.global_step, metrics)
                self._swa_update(epoch)
                if self._should_early_stop(metrics):
                    LOGGER.info(f'Early stopping at epoch {epoch}.')
                    break
            self._swa_finalize()
            self.ckpt.finalize()  # the last asynchronous save is on the disk
            if self.manager:
                self.manager.on_fit_end()
        except BaseException:
            try:
                self.ckpt.finalize()
            except Exception:  # noqa: BLE001 - the first error is the one raised
                LOGGER.exception('Asynchronous checkpoint save failed during cleanup.')
            if self.manager:
                self.manager.cleanup()
            raise

    # ----------------------------------------------------------------- epochs
    def train_epoch(self, epoch: int) -> None:
        self.train_dl.set_epoch(epoch)
        # Both per-step random streams are seeded by (cfg seed, epoch), as in
        # the JAX package: the AR-aug bucket sequence and the step seeds of a
        # run depend on nothing else.
        seed = int(self.cfg.get('seed', 42))
        rng = np.random.default_rng(seed + 1000003 * epoch)
        ar_rng = _random.Random(seed * 7919 + epoch)
        last_scalars = None

        batches = iter(self.train_dl)
        while True:
            with self.timer('Loader'):
                batch = next(batches, None)
            if batch is None:
                break
            x, y, m = batch
            supp_idxs = tuple(int(v) for v in x.get('supp_idxs', ()))
            with self.timer('Place'):
                xb, yb = self._place(x, y)
            with self.timer('ArAug'):
                xb, yb, m = self.ar_aug((xb, yb, m), rng=ar_rng)

            step = self._step_fn(supp_idxs, train=True)
            with self.timer('Step'):
                scalars = step(xb, yb, **self.step_randomness(int(rng.integers(2 ** 31))))
            last_scalars = scalars
            self.last_batch = ((xb, yb, m), supp_idxs)
            self.global_step += 1

            if self.global_step % self.log_every_n == 0:
                h, w = xb['imgs'].shape[1:3]  # this step's augmentation bucket
                self._log('train', {**scalars, 'height': h, 'width': w}, m)

        # Epoch-end anomaly check (sync point; the carried `bad_step` flag
        # reports the FIRST bad step, not just the last one of the epoch).
        if last_scalars is not None:
            float(last_scalars['loss'])  # Sync before reading the flag.
            self._check_anomaly()

        if self.heavy_logger is not None and self.last_batch is not None:
            batch, supp_idxs = self.last_batch
            with self.timer('HeavyLogger'):
                self.heavy_logger.log_step(self.trainer, batch, supp_idxs, self.writer, epoch,
                                           mode='train')

    def val_epoch(self, epoch: int) -> dict:
        if self.val_dl is None:
            return {}
        self.val_dl.set_epoch(epoch)
        acc: dict = {}
        n = 0
        for i, (x, y, m) in enumerate(self.val_dl):
            if i >= self.limit_val_batches:
                break
            supp_idxs = tuple(int(v) for v in x.get('supp_idxs', ()))
            with self.timer('Val'):
                xb, yb = self._place(x, y)
                step = self._step_fn(supp_idxs, train=False)
                scalars = step(xb, yb, **self.step_randomness(epoch))
                for k, v in scalars.items():
                    acc[k] = acc.get(k, 0.0) + float(v)
            n += 1
        metrics = {k: v / max(n, 1) for k, v in acc.items()}
        if metrics:
            self._log_dict('val', metrics)
            LOGGER.info(f"Epoch {epoch}: val loss={metrics.get('loss'):.4f}")
        return metrics

    # ---------------------------------------------------------------- logging
    def _check_anomaly(self) -> None:
        """Raise if any step since the start saw a non-finite loss (the step's
        device-side `bad_step` tripwire). Only called where a host fetch
        happens anyway."""
        bad = self.trainer.bad_step
        if bad is not None and int(bad) >= 0:
            raise ValueError(f'Detected NaN/Infinite loss (first at step {int(bad)})')

    def _log(self, mode: str, scalars: dict, m: dict) -> None:
        vals = {k: float(v) for k, v in scalars.items()}
        self._check_anomaly()
        loss = vals.get('loss', float('nan'))
        if not math.isfinite(loss):
            raise ValueError(f'Detected NaN/Infinite loss: "{loss}"')
        out = {f'{mode}_losses/{k.replace("loss_", "")}' if k.startswith('loss') else
               f'{mode}_monitor/{k}': v for k, v in vals.items()}
        if m.get('timer_data'):
            t0 = m['timer_data'][0]
            out.update({f'{mode}_timer/Data/{k}': v
                        for k, v in t0.mean_elapsed(m['timer_data']).items()})
        self._log_dict(mode, out, raw=True)
        LOGGER.info(f'step {self.global_step}: loss={loss:.4f}')

    def _log_dict(self, mode: str, metrics: dict, raw: bool = False) -> None:
        if self.writer is None:
            return
        items = metrics if raw else flatten_dict({f'{mode}_metrics': metrics})
        for k, v in items.items():
            if isinstance(v, (int, float)) and math.isfinite(v):
                self.writer.add_scalar(k, v, self.global_step)

    # -------------------------------------------------------------- callbacks
    def _swa_update(self, epoch: int) -> None:
        """Accumulate the SWA running sum of the parameters over the last 25% of
        epochs. Buffers (BatchNorm's running statistics) are not averaged: the JAX
        package averages `state.params` only."""
        if not self.use_swa or epoch < int(0.75 * self.max_epochs):
            return
        params = {n: dict(net.named_parameters()) for n, net in self.trainer.nets.items()}
        if self._swa_sum is None:
            self._swa_sum = {n: {k: v.detach().to(torch.float32, copy=True)
                                 for k, v in ps.items()} for n, ps in params.items()}
        else:
            for n, ps in params.items():
                for k, v in ps.items():
                    self._swa_sum[n][k] += v.detach()
        self._swa_n += 1

    def _swa_finalize(self) -> None:
        """`swa.ckpt`: the averaged parameters and the buffers' current values
        (as the JAX package's `state.replace(params=avg)` keeps `aux`)."""
        if not self.use_swa or self._swa_sum is None:
            return
        avg = {n: {**dict(self.trainer.nets[n].named_buffers()),
                   **{k: v / self._swa_n for k, v in sd.items()}}
               for n, sd in self._swa_sum.items()}
        save_checkpoint(self.ckpt_dir / 'swa.ckpt', avg, self.cfg)
        LOGGER.info(f'SWA checkpoint over {self._swa_n} epochs -> {self.ckpt_dir / "swa.ckpt"}')

    def _should_early_stop(self, metrics: dict) -> bool:
        """Patience-based early stopping on the monitor (patience 5 for `True`)."""
        if not self.early_stopping or not metrics:
            return False
        patience = 5 if self.early_stopping is True else int(self.early_stopping)
        value = metrics.get(self.monitor)
        if value is None:
            return False
        better = self._es_best is None or (
            value > self._es_best if self.ckpt.mode == 'max' else value < self._es_best)
        if better:
            self._es_best = value
            self._es_bad_epochs = 0
        else:
            self._es_bad_epochs += 1
        return self._es_bad_epochs >= patience
