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
Ported losses: `img_recon` (with predicted masks or 'l2'), `feat_recon`,
`autoenc_recon`, `stereo_const`, `depth_regr` (with the Depth-Hints
automask), `disp_smooth` (Laplacian, blur), `feat_peaky`, `feat_smooth`,
`disp_occ` and `disp_mask`: the KBR, Monodepth, Garg, MonoResMatch, DVSO,
Kuznietsov, Depth-Hints, SfM-Learner, Klodt, Depth-VO-Feat and FeatDepth
recipes. The net dict may lack the pose net (a stereo-only support) and may
hold the image autoencoder (FeatDepth).

The depth net's two skip-less decoder stages run fused, forward (kernel 3)
and backward (kernel 4), as in serving, where the decoder has one output
channel (not with virtual stereo, not in the mask decoder). `trainer.warp_bf16` quantizes the
warp sources to bfloat16 and runs the packed warp (kernel 6).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

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
        """Depth, pose and autoencoder nets -> {depth_feats (NCHW), disp {s: (b,
        h/2**s, w/2**s, 1)}, [disp_stereo {s: (..., 2)}], [mask {s: (..., n)}], T_i
        (b, 4, 4), [fs, cs (n, b, 2), K (b, 4, 4)], [autoenc_feats [(b, h/r, w/r,
        c)], autoenc_imgs {s: (b, h/2**s, w/2**s, 3)}, supp_autoenc_feats and
        supp_autoenc_imgs with a leading support axis n]}, maps NHWC.

        The autoencoder runs on the targets, then once on all n * b support frames in
        the same mode: in train mode BatchNorm takes each pass's batch statistics and
        updates its running statistics twice, the second on the first's update, as
        the JAX package's support pass chains on its target pass's."""
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
            elif key == 'autoencoder':
                n, b = x['supp_imgs'].shape[:2]
                out = net(imgs.permute(0, 3, 1, 2))
                fwd['autoenc_feats'] = [f.permute(0, 2, 3, 1) for f in out['autoenc_feats']]
                fwd['autoenc_imgs'] = {s: v.permute(0, 2, 3, 1)
                                       for s, v in out['autoenc_imgs'].items()}
                out = net(x['supp_imgs'].flatten(0, 1).permute(0, 3, 1, 2))
                fwd['supp_autoenc_feats'] = [f.permute(0, 2, 3, 1).unflatten(0, (n, b))
                                             for f in out['autoenc_feats']]
                fwd['supp_autoenc_imgs'] = {s: v.permute(0, 2, 3, 1).unflatten(0, (n, b))
                                            for s, v in out['autoenc_imgs'].items()}
            else:
                raise KeyError(f'Unrecognized net key: {key}.')
        return fwd

    def extract_features(self, fwd: dict, x: dict) -> tuple[list, list]:
        """The features `feat_recon` warps -> (target's [(b, h/r, w/r, c)], supports'
        [(n, b, h/r, w/r, c)]), NHWC: the autoencoder's where there is one, else the
        depth net's and a pass of the depth encoder over all n * b support frames.

        That pass runs in the step's mode (train mode: BatchNorm on the batch's
        statistics, as the JAX package's) under `no_grad`: the handler stops the
        features' gradient anyway. The JAX package discards its running-statistics
        update, so the pass leaves every buffer of the depth net as it found it."""
        if 'autoencoder' in self.nets:
            return fwd['autoenc_feats'], fwd['supp_autoenc_feats']
        net = self.nets['depth']
        n, b = x['supp_imgs'].shape[:2]
        buffers = {k: v.clone() for k, v in net.named_buffers()}
        with torch.no_grad():
            supp = net.encoder(x['supp_imgs'].flatten(0, 1).permute(0, 3, 1, 2)
                               .contiguous(memory_format=torch.channels_last))
            for k, v in net.named_buffers():
                v.copy_(buffers[k])
        feats = [f.permute(0, 2, 3, 1) for f in fwd['depth_feats']]
        return feats, [f.permute(0, 2, 3, 1).unflatten(0, (n, b)) for f in supp]

    def forward_postprocess(self, fwd: dict, x: dict, y: dict, supp_idxs: tuple) -> dict:
        """Upsample the disparities (and convert them to depth), the masks and the
        autoencoder's images, keep the virtual-stereo channel that faces the real
        stereo pair, stack the poses (`T_stereo` from `y` for a stereo support,
        index 0)."""
        imgs = x['imgs']
        new = {}
        for k, v in fwd.items():
            if 'disp' in k:
                new[f'{k}_up'] = {s: resize_like(d, imgs) for s, d in v.items()}
                new[f'{k}_up'.replace('disp', 'depth')] = {
                    s: self.to_depth(d) for s, d in new[f'{k}_up'].items()}
            elif 'mask' in k or k == 'autoenc_imgs':
                new[f'{k}_up'] = {s: resize_like(m, imgs) for s, m in v.items()}
            elif k == 'supp_autoenc_imgs':
                new[f'{k}_up'] = {s: resize_like(m.flatten(0, 1), imgs).unflatten(0, m.shape[:2])
                                  for s, m in v.items()}
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
                     noise: Optional[Union[torch.Tensor, dict]] = None, supp_idxs: tuple = (),
                     x: Optional[dict] = None):
        """Weighted sum of the configured losses -> (loss, loss_dict).

        With virtual stereo, `img_recon`, `disp_smooth` and `disp_occ` also
        run on the stereo view (keys `loss_stereo_<k>`, `stereo_<k>`): the
        virtual view is rebuilt from the target image through T_stereo^-1.

        :param generator: draws the automask tie-break noise of `img_recon` and,
            apart from it, of `feat_recon`.
        :param noise: or that noise itself: `img_recon`'s, (n_scales * b, h, w, 1),
            or {'img_recon': it, 'feat_recon': (b, h, w, 1)}. The stereo view's
            reconstruction takes `img_recon`'s, as the JAX package's takes the
            same key; the JAX package draws each loss's from a key of its own.
        :param supp_idxs: the supports' indices (which one is the stereo frame).
        :param x: the network inputs: `feat_recon` without an autoencoder passes
            their supports through the depth encoder (`extract_features`).
        """
        noises = noise if isinstance(noise, dict) else {'img_recon': noise}
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
                nz = noises.get(k)
                if crit.use_automask and nz is None and generator is not None:
                    d0 = fwd['depth_up'][min(fwd['depth_up'])]
                    nz = torch.randn((len(fwd['depth_up']) * d0.shape[0],) + d0.shape[1:],
                                     generator=generator, dtype=d0.dtype, device=d0.device)
                l, ld = h.image_recon(crit, fwd['depth_up'], y['imgs'], y['supp_imgs'],
                                      fwd['Ts'], Ks, noise=nz, kernels=self.kernels,
                                      warp_bf16=self.warp_bf16, masks=fwd.get('mask_up'))
                if stereo:
                    l2, ld2 = h.image_recon(
                        crit, fwd['depth_stereo_up'], y['imgs_stereo'], y['imgs'][None],
                        rigid_inverse(y['T_stereo'])[None], Ks, noise=nz,
                        kernels=self.kernels, warp_bf16=self.warp_bf16,
                        masks=fwd.get('mask_stereo_up'))
            elif k == 'feat_recon':
                feats, supp_feats = self.extract_features(fwd, x)
                l, ld = h.feat_recon(crit, fwd['depth_up'], feats, supp_feats, fwd['Ts'], Ks,
                                     generator=generator, noise=noises.get(k),
                                     kernels=self.kernels, masks=fwd.get('mask_up'))
            elif k == 'autoenc_recon':
                l, ld = h.autoenc_recon(crit, fwd['autoenc_imgs_up'], y['imgs'],
                                        fwd['supp_autoenc_imgs_up'], y['supp_imgs'])
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
            elif k in ('feat_peaky', 'feat_smooth'):
                l, ld = h.feat_smooth(crit, fwd['autoenc_feats'], y['imgs'],
                                      fwd['supp_autoenc_feats'], y['supp_imgs'])
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
                raise ValueError(f'Missing loss key: "{k}"')
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
                noise: Optional[Union[torch.Tensor, dict]] = None):
        """forward -> postprocess -> loss: -> (loss, (loss_dict, fwd))."""
        fwd = self.forward(x, supp_idxs)
        fwd = self.forward_postprocess(fwd, x, y, supp_idxs)
        loss, loss_dict = self.forward_loss(fwd, y, generator, noise, supp_idxs, x)
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
                      noise: Optional[Union[torch.Tensor, dict]] = None) -> dict:
            self.nets.eval()
            with torch.no_grad():
                loss, (ld, fwd) = self.loss_fn(x, y, supp_idxs, generator, noise)
            return self.scalars(loss, ld, fwd, y)

        if not train:
            return eval_step

        def step(x: dict, y: dict, generator: Optional[torch.Generator] = None,
                 noise: Optional[Union[torch.Tensor, dict]] = None) -> dict:
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
