"""Asynchronous checkpoint saves (`CheckpointManager(async_save=True)`, the
loop's `trainer.async_ckpt`).

1. The file holds the state at the moment of the save: the background write
   is held back (monkeypatched) until an optimizer update has changed the
   parameters and Adam's moments in place; the file must still hold the
   state from before that update, bit for bit. A snapshot by reference (no
   clones) fails.
2. A failure in the background raises at the next save and at `finalize`,
   never dropped.
3. A run with `async_ckpt` resumes from its `last.ckpt` exactly as a run
   with synchronous saves does: the same files, and the same losses after
   the resume (CPU, so bitwise).
"""
import threading

import numpy as np
import pytest
import torch
import torch.nn as nn

from slowtv_monodepth_tpu_torch import parsers
from slowtv_monodepth_tpu_torch.core import MonoDepthLoop, checkpoint
from slowtv_monodepth_tpu_torch.core.checkpoint import CheckpointManager
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

CFG = {'optimizer': {'type': 'adamw', 'lr': 1e-2, 'weight_decay': 1e-3}}


def _nets_and_opt():
    torch.manual_seed(0)
    nets = nn.ModuleDict({'depth': nn.Sequential(nn.Linear(6, 5), nn.LayerNorm(5))})
    return nets, parsers.make_optimizer(CFG, nets)


def _update(nets, opt, seed: int) -> None:
    rs = np.random.RandomState(seed)
    for p in nets.parameters():
        p.grad = torch.from_numpy(rs.standard_normal(p.shape).astype(np.float32))
    opt.step()


def _host_state(nets, opt) -> dict:
    """Every tensor of the state, copied to the host."""
    sd = {f'nets.{k}': v.clone() for k, v in nets['depth'].state_dict().items()}
    for i, st in opt.state_dict()['opt']['state'].items():
        sd.update({f'opt.{i}.{k}': v.clone() for k, v in st.items()})
    return sd


def _file_state(path) -> dict:
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    sd = {f'nets.{k[len("nets.depth."):]}': v for k, v in ckpt['state_dict'].items()}
    for i, st in ckpt['optimizer']['opt']['state'].items():
        sd.update({f'opt.{i}.{k}': v for k, v in st.items()})
    return sd


def _save_then_update(tmp_path, monkeypatch) -> tuple[dict, dict]:
    """-> (the state at the save, the state in the file written after one more update)."""
    nets, opt = _nets_and_opt()
    _update(nets, opt, 1)
    gate, write = threading.Event(), checkpoint._write

    def held_back(path, ckpt):
        assert gate.wait(10)
        write(path, ckpt)

    monkeypatch.setattr(checkpoint, '_write', held_back)
    mgr = CheckpointManager(tmp_path, monitor='loss', async_save=True)
    at_save = _host_state(nets, opt)
    mgr.step(nets, opt, {}, epoch=0, step=1, metrics={'loss': 1.0})
    _update(nets, opt, 2)  # in place: parameters and moments
    assert not all(torch.equal(v, at_save[k]) for k, v in _host_state(nets, opt).items())
    gate.set()
    mgr.finalize()
    return at_save, _file_state(tmp_path / 'last.ckpt')


def test_the_file_holds_the_state_at_the_save(tmp_path, monkeypatch):
    at_save, in_file = _save_then_update(tmp_path, monkeypatch)
    assert sorted(in_file) == sorted(at_save)
    assert [k for k, v in at_save.items() if not torch.equal(in_file[k], v)] == []
    assert (tmp_path / 'best.ckpt').is_file() and (tmp_path / 'last.json').is_file()


def test_a_snapshot_by_reference_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(checkpoint, 'snapshot', lambda ckpt: (ckpt, None))
    at_save, in_file = _save_then_update(tmp_path, monkeypatch)
    assert [k for k, v in at_save.items() if not torch.equal(in_file[k], v)]


@pytest.mark.parametrize('where', ['next_save', 'finalize'])
def test_a_failed_background_save_raises(tmp_path, monkeypatch, where):
    nets, opt = _nets_and_opt()
    calls = []

    def failing(path, ckpt):
        calls.append(path)
        raise OSError('disk full')

    monkeypatch.setattr(checkpoint, '_write', failing)
    mgr = CheckpointManager(tmp_path, monitor='loss', async_save=True)
    mgr.step(nets, opt, {}, epoch=0, step=0, metrics={})  # returns: the write is in flight
    with pytest.raises(OSError, match='disk full'):
        if where == 'next_save':
            mgr.step(nets, opt, {}, epoch=1, step=0, metrics={})
        else:
            mgr.finalize()
    assert len(calls) == 1
    mgr.finalize()  # raised once, then clear


# ------------------------------------------------------------ 3. resume
B, H, W = 2, 64, 96
NET = {'depth': {'enc_name': 'convnext_atto', 'pretrained': False, 'dec_name': 'monodepth',
                 'out_scales': [0, 1]},
       'pose': {'enc_name': 'convnext_atto', 'pretrained': False, 'learn_K': True}}
LOSS = {'img_recon': {'weight': 1, 'use_min': True, 'use_automask': True},
        'disp_smooth': {'weight': 0.001, 'use_edges': True}}


class _Batches:
    """Two seeded batches an epoch: x standardized, y raw, two shifted supports."""

    def __len__(self):
        return 2

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        for i in range(2):
            imgs = np.random.RandomState(100 * self.epoch + i).rand(B, H, W, 3).astype(np.float32)
            supp = np.stack([np.roll(imgs, 2, axis=2), np.roll(imgs, -2, axis=2)])
            K = np.array([[0.58 * W, 0, 0.5 * W, 0], [0, 1.92 * H, 0.5 * H, 0], [0, 0, 1, 0],
                          [0, 0, 0, 1]], np.float32)
            x = {'imgs': imgs, 'supp_imgs': supp, 'supp_idxs': np.array([-1, 1])}
            y = {'imgs': imgs, 'supp_imgs': supp,
                 'K': np.ascontiguousarray(np.broadcast_to(K, (B, 4, 4)))}
            yield x, y, {}


class _Losses:
    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == 'train_losses/loss':
            self.losses.append(value)


def _fit(run_dir, async_ckpt: bool, epochs: int) -> list:
    cfg = {'net': NET, 'loss': LOSS, 'optimizer': CFG['optimizer'],
           'trainer': {'max_epochs': epochs, 'accumulate_grad_batches': 2, 'min_depth': 0.1,
                       'max_depth': 100, 'log_every_n_steps': 1, 'monitor': 'loss',
                       'async_ckpt': async_ckpt}}
    writer = _Losses()
    MonoDepthLoop(cfg, run_dir, device='cpu', writer=writer, train_dl=_Batches(),
                  use_markers=False).fit()
    return writer.losses


def test_resume_from_an_async_save_equals_resume_from_a_sync_one(tmp_path):
    runs = {}
    for mode in (True, False):
        run_dir = tmp_path / str(mode)
        first = _fit(run_dir, mode, epochs=1)
        saved = _file_state(run_dir / 'last.ckpt')
        runs[mode] = (first, saved, _fit(run_dir, mode, epochs=2))
        for f in run_dir.glob('*.ckpt'):
            f.unlink()
    (first_a, saved_a, resumed_a), (first_s, saved_s, resumed_s) = runs[True], runs[False]
    assert first_a == first_s and len(resumed_a) == 2
    assert sorted(saved_a) == sorted(saved_s)
    assert all(torch.equal(saved_a[k], saved_s[k]) for k in saved_s)
    assert resumed_a == resumed_s
