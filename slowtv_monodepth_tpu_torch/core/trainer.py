"""The training step (PyTorch port).

Counterpart of `slowtv_monodepth_tpu/core/trainer.py:MonoDepthTrainer`: the
same forward -> postprocess -> loss chain, with the nets as `nn.Module`s and
the optimizer from `parsers.make_optimizer`:

    trainer = MonoDepthTrainer(cfg).to('cuda')
    opt = parsers.make_optimizer(cfg, trainer.nets, steps_per_epoch, accumulate=2)
    step = trainer.make_step_fn(supp_idxs, opt)
    scalars = step(x, y, generator=gen)           # one micro-step

Batches are NHWC, as in the JAX package:
    x = {imgs (b, h, w, 3), supp_imgs (n, b, h, w, 3)}
    y = {imgs, supp_imgs, K (b, 4, 4), [T_stereo (b, 4, 4)], [depth (b, h', w', 1)],
         [depth_hints (b, h, w, 1)]}
Ported losses: `img_recon` (with predicted masks or 'l2'), `stereo_const`,
`depth_regr` (with the Depth-Hints automask), `disp_smooth` (Laplacian,
blur), `disp_occ` and `disp_mask`: the KBR, Monodepth, Garg, MonoResMatch,
DVSO, Kuznietsov, Depth-Hints, SfM-Learner and Klodt recipes. The net dict
may lack the pose net (a stereo-only support). The feature losses raise
`NotImplementedError` in `parsers.get_loss` (ROADMAP queue A item 9b).

The depth net's two skip-less decoder stages run fused, forward (kernel 3)
and backward (kernel 4), as in serving, where the decoder has one output
channel (not with virtual stereo, not in the mask decoder). `trainer.warp_bf16` quantizes the
warp sources to bfloat16 and runs the packed warp (kernel 6).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import parsers
from ..models import PoseNet
from ..models.encoders.pretrained import load_pretrained_encoder
from ..ops import T_from_AAt, resize_K, resize_like, to_inv, to_scaled
from . import handlers as h
from .handlers import rigid_inverse
from .train_metrics import compute_train_metrics

__all__ = ['MonoDepthTrainer']


class MonoDepthTrainer:
    """Nets, losses and the step of monodepth training.

    :param cfg: {net, loss, [trainer], [optimizer], [scheduler]} as the JAX
        package's cfg.
    :param kernels: run the hand-written kernels (depthwise conv, decoder
        stage, warp, photometric error). False runs their plain PyTorch
        versions: only for timing the plain path on the card.
    """

    def __init__(self, cfg: dict, kernels: bool = True):
        self.cfg = cfg
        self.kernels = kernels
        self.nets = parsers.get_net(cfg['net'], kernels=kernels)
        for key, net in self.nets.items():  # after the initial draw, as the JAX `init_state`
            if net.pretrained:
                load_pretrained_encoder(net, net.enc_name, in_chans=6 if key == 'pose' else 3)
        self.losses, self.weights = parsers.get_loss(cfg['loss'], kernels=kernels)

        tcfg = cfg.get('trainer', {})
        self.min_depth = tcfg.get('min_depth', None)
        self.max_depth = tcfg.get('max_depth', None)
        self.should_scale = bool(self.min_depth or self.max_depth)
        self.always_fwd_pose = tcfg.get('always_fwd_pose', True)
        if str(tcfg.get('precision', 32)) != '32' or tcfg.get('remat'):
            raise NotImplementedError('precision / remat are TPU recipe options; the port '
                                      'trains in float32 (ROADMAP ground rule "Recipe").')
        self.warp_bf16 = bool(tcfg.get('warp_bf16', False))
        self.scales = tuple(self.nets['depth'].out_sc)
        # Device-side tripwire (the JAX TrainState's `bad_step`): the index of the
        # first micro-step whose loss was not finite, -1 while clean.
        self.step_count: Optional[torch.Tensor] = None
        self.bad_step: Optional[torch.Tensor] = None

    def to(self, device) -> 'MonoDepthTrainer':
        self.nets.to(device)
        return self

    def to_depth(self, disp: torch.Tensor) -> torch.Tensor:
        """Sigmoid disparity -> scaled depth."""
        if self.should_scale:
            return to_scaled(disp, self.min_depth, self.max_depth)[1]
        return to_inv(disp)

    # ---------------------------------------------------------------- forward
    def forward(self, x: dict, supp_idxs: tuple) -> dict:
        """Depth and pose nets -> {depth_feats, disp {s: (b, h/2**s, w/2**s, 1)},
        [disp_stereo {s: (..., 2)}], [mask {s: (..., n)}], T_i (b, 4, 4),
        [fs, cs (n, b, 2), K (b, 4, 4)]}, maps NHWC."""
        fwd: dict = {}
        imgs = x['imgs']
        for key, net in self.nets.items():
            if key == 'depth':
                out = net(imgs.permute(0, 3, 1, 2))
                fwd['depth_feats'] = out['depth_feats']
                for k in ('disp', 'disp_stereo', 'mask'):
                    if k in out:
                        fwd[k] = {s: d.permute(0, 2, 3, 1) for s, d in out[k].items()}
            elif key == 'pose':
                def should_inv(i):
                    return self.always_fwd_pose and i < 0
                idxs = [i for i in supp_idxs if i != 0]
                pairs = torch.stack([
                    torch.cat([supp, imgs] if should_inv(i) else [imgs, supp], -1)
                    for i, supp in zip(supp_idxs, x['supp_imgs']) if i != 0])  # (n', b, h, w, 6)
                n, b = pairs.shape[:2]
                out = net(pairs.reshape((n * b,) + pairs.shape[2:]).permute(0, 3, 1, 2))
                Ts = T_from_AAt(out['R'][:, 0], out['t'][:, 0]).reshape(n, b, 4, 4)
                for i, T in zip(idxs, Ts):
                    fwd[f'T_{i}'] = rigid_inverse(T) if should_inv(i) else T
                if 'fs' in out:
                    fwd['fs'] = out['fs'].reshape(n, b, 2)
                    fwd['cs'] = out['cs'].reshape(n, b, 2)
                    # The intrinsics predicted with the first support frame.
                    K = PoseNet.build_K(out['fs'], out['cs']).reshape(n, b, 4, 4)[0]
                    fwd['K'] = resize_K(K, imgs.shape[1:3])
            else:
                raise NotImplementedError(
                    f'Net "{key}" is not ported yet (ROADMAP queue A item 9b).')
        return fwd

    def forward_postprocess(self, fwd: dict, x: dict, y: dict, supp_idxs: tuple) -> dict:
        """Upsample the disparities (and convert them to depth) and the masks,
        keep the virtual-stereo channel that faces the real stereo pair, stack
        the poses (`T_stereo` from `y` for a stereo support, index 0)."""
        imgs = x['imgs']
        new = {}
        for k, v in fwd.items():
            if 'disp' in k:
                new[f'{k}_up'] = {s: resize_like(d, imgs) for s, d in v.items()}
                new[f'{k}_up'.replace('disp', 'depth')] = {
                    s: self.to_depth(d) for s, d in new[f'{k}_up'].items()}
            elif 'mask' in k:
                new[f'{k}_up'] = {s: resize_like(m, imgs) for s, m in v.items()}
        fwd.update(new)

        if 'disp_stereo' in fwd:
            if 'T_stereo' not in y:
                raise KeyError('Missing stereo transform "T_stereo".')
            # Channel 1 (the right view) where the stereo frame lies to the right.
            idx = (y['T_stereo'][:, 0, 3] > 0).long()[:, None, None, None]
            for k in ('disp_stereo', 'disp_stereo_up', 'depth_stereo_up', 'mask_stereo',
                      'mask_stereo_up'):
                if k in fwd:
                    fwd[k] = {s: torch.gather(d, -1, idx.expand(d.shape[:-1] + (1,)))
                              for s, d in fwd[k].items()}
        fwd['Ts'] = torch.stack([y['T_stereo'] if i == 0 else fwd[f'T_{i}'] for i in supp_idxs])
        return fwd

    def forward_loss(self, fwd: dict, y: dict, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None, supp_idxs: tuple = ()):
        """Weighted sum of the configured losses -> (loss, loss_dict).

        With virtual stereo, `img_recon`, `disp_smooth` and `disp_occ` also
        run on the stereo view (keys `loss_stereo_<k>`, `stereo_<k>`): the
        virtual view is rebuilt from the target image through T_stereo^-1.

        :param generator: draws the automask tie-break noise of `img_recon`.
        :param noise: or that noise itself, (n_scales * b, h, w, 1). The
            stereo view's reconstruction takes the same noise, as the JAX
            package's takes the same key.
        :param supp_idxs: the supports' indices (which one is the stereo frame).
        """
        y = dict(y)
        idx_stereo = next((j for j, i in enumerate(supp_idxs) if i == 0), None)
        if 'disp_stereo' in fwd and idx_stereo is not None:
            y['imgs_stereo'] = y['supp_imgs'][idx_stereo]
        Ks = fwd.get('K', y['K'])
        stereo = 'disp_stereo' in fwd
        loss = torch.zeros((), device=y['imgs'].device)
        loss_dict: dict = {}
        for k, crit in self.losses.items():
            l2, ld2 = None, None
            if k == 'img_recon':
                if crit.use_automask and noise is None and generator is not None:
                    d0 = fwd['depth_up'][min(fwd['depth_up'])]
                    noise = torch.randn((len(fwd['depth_up']) * d0.shape[0],) + d0.shape[1:],
                                        generator=generator, dtype=d0.dtype, device=d0.device)
                l, ld = h.image_recon(crit, fwd['depth_up'], y['imgs'], y['supp_imgs'],
                                      fwd['Ts'], Ks, noise=noise, kernels=self.kernels,
                                      warp_bf16=self.warp_bf16, masks=fwd.get('mask_up'))
                if stereo:
                    l2, ld2 = h.image_recon(
                        crit, fwd['depth_stereo_up'], y['imgs_stereo'], y['imgs'][None],
                        rigid_inverse(y['T_stereo'])[None], Ks, noise=noise,
                        kernels=self.kernels, warp_bf16=self.warp_bf16,
                        masks=fwd.get('mask_stereo_up'))
            elif k == 'stereo_const':
                if not stereo:
                    raise KeyError('Missing virtual stereo prediction "disp_stereo".')
                l, ld = h.stereo_const(crit, fwd['disp_up'], fwd['depth_up'],
                                       fwd['disp_stereo_up'], fwd['depth_stereo_up'],
                                       y['T_stereo'], Ks, kernels=self.kernels)
            elif k == 'depth_regr':
                if 'depth_hints' not in y:
                    raise KeyError('Missing proxy depth prediction "depth_hints".')
                l, ld = h.depth_regr(crit, self.losses['img_recon'].compute_photo,
                                     fwd['depth_up'], y['depth_hints'], y['imgs'],
                                     y['supp_imgs'], fwd['Ts'], Ks, kernels=self.kernels)
            elif k == 'disp_smooth':
                l, ld = h.disp_smooth(crit, fwd['disp'], y['imgs'])
                if stereo:
                    l2, ld2 = h.disp_smooth(crit, fwd['disp_stereo'], y['imgs_stereo'])
            elif k == 'disp_occ':
                l, ld = h.disp_occ(crit, fwd['disp'])
                if stereo:
                    l = l + h.disp_occ(crit, fwd['disp_stereo'])[0]
            elif k == 'disp_mask':
                if 'mask' not in fwd:
                    raise KeyError('Missing masks in predictions.')
                l, ld = h.disp_mask(crit, fwd['mask'])
                if 'mask_stereo' in fwd:
                    l = l + h.disp_mask(crit, fwd['mask_stereo'])[0]
            else:
                raise NotImplementedError(
                    f'Loss "{k}" is not ported yet (ROADMAP queue A item 9b).')
            loss = loss + self.weights[k] * l
            loss_dict[f'loss_{k}'] = l
            loss_dict.update(ld)
            if l2 is not None:
                loss = loss + self.weights[k] * l2
                loss_dict[f'loss_stereo_{k}'] = l2
                loss_dict.update({f'stereo_{kk}': v for kk, v in ld2.items()})
        return loss, loss_dict

    def loss_fn(self, x: dict, y: dict, supp_idxs: tuple,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """forward -> postprocess -> loss: -> (loss, (loss_dict, fwd))."""
        fwd = self.forward(x, supp_idxs)
        fwd = self.forward_postprocess(fwd, x, y, supp_idxs)
        loss, loss_dict = self.forward_loss(fwd, y, generator, noise, supp_idxs)
        return loss, (loss_dict, fwd)

    @torch.no_grad()
    def scalars(self, loss: torch.Tensor, loss_dict: dict, fwd: dict, y: dict) -> dict:
        """Scalar summaries, as device tensors (no host sync); with a depth
        target in `y` also the median-aligned train metrics of the finest depth."""
        out = {'loss': loss.detach()}
        out.update({k: v.detach() for k, v in loss_dict.items()
                    if k.startswith('loss_') and v.dim() == 0})
        for s, d in fwd['disp_up'].items():
            out[f'disp_mean_{s}'] = d.mean()
        for s, d in fwd['depth_up'].items():
            out[f'depth_mean_{s}'] = d.mean()
        for k, v in fwd.items():
            if k.startswith('T_') and k != 'Ts':
                out[f'{k}_t_mean'] = v[..., :3, 3].norm(dim=-1).mean()
        if 'fs' in fwd:
            out['fx'], out['fy'] = fwd['fs'][..., 0].mean(), fwd['fs'][..., 1].mean()
            out['cx'], out['cy'] = fwd['cs'][..., 0].mean(), fwd['cs'][..., 1].mean()
        if 'depth' in y:
            pred = resize_like(fwd['depth_up'][min(fwd['depth_up'])], y['depth'])
            out.update(compute_train_metrics(pred.detach(), y['depth'],
                                             self.min_depth or 0.1, self.max_depth or 100))
        return out

    # ------------------------------------------------------------------- step
    def make_step_fn(self, supp_idxs: tuple, opt: Optional[parsers.Optimizer] = None,
                     train: bool = True) -> Callable:
        """-> step(x, y, generator=None, noise=None) -> scalars: one micro-step.

        Forward, loss, backward, `opt.step()` (an update every `accumulate`
        micro-steps), and the `bad_step` tripwire, all without a host sync.
        `train=False` gives the validation step: forward and loss in eval
        mode under `no_grad`, nothing updated and nothing counted.
        """
        supp_idxs = tuple(supp_idxs)

        def eval_step(x: dict, y: dict, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> dict:
            self.nets.eval()
            with torch.no_grad():
                loss, (ld, fwd) = self.loss_fn(x, y, supp_idxs, generator, noise)
            return self.scalars(loss, ld, fwd, y)

        if not train:
            return eval_step

        def step(x: dict, y: dict, generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> dict:
            self.nets.train()
            loss, (ld, fwd) = self.loss_fn(x, y, supp_idxs, generator, noise)
            loss.backward()
            opt.step()
            if self.step_count is None:
                self.step_count = torch.zeros((), dtype=torch.int64, device=loss.device)
                self.bad_step = torch.full_like(self.step_count, -1)
            self.bad_step = torch.where((self.bad_step < 0) & ~torch.isfinite(loss),
                                        self.step_count, self.bad_step)
            self.step_count += 1
            return self.scalars(loss, ld, fwd, y)

        return step
