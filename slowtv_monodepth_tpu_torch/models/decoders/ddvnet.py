"""DDV-Net decoder (PyTorch, NCHW): a discrete disparity volume behind a
self-attention bottleneck.

Counterpart of `slowtv_monodepth_tpu/models/decoders/ddvnet.py`. Each output
is the softmax expectation over `num_bins` linear disparity bins, per output
channel. The bottleneck's attention has no 1 / sqrt(c) scale, so it is
written out (einsum, softmax, einsum): `F.scaled_dot_product_attention`'s
default scale would change it.

`state_dict()` keys are the reference's plain list `decoder.{idx}`:
`decoder.0.{query,key,value}_conv.0.*`, then a ConvBlock each for
upconv_4_0, upconv_4_1, ..., upconv_0_1 (`decoder.{idx}.conv.*`), then one
out conv per `out_sc` (`decoder.{idx}.*`). The reference also keeps its bin
centres as a `bins` buffer, a constant recomputed here
(`unused_reference_keys` names it).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .utils import ACT, ConvBlock, conv1x1, conv3x3, upsample2x

__all__ = ['DDVNetDecoder', 'get_discrete_bins']


def get_discrete_bins(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """The n linear bin centres of the sigmoid disparity, i / n (the JAX package's
    'linear' mode, the one its decoder uses). Made on `device`, so a forward copies
    nothing from the host."""
    return torch.arange(n, device=device, dtype=dtype) / n


class SelfAttentionBlock(nn.Module):
    """Dense self-attention over the flattened pixels, unscaled."""

    def __init__(self, ch: int):
        super().__init__()
        self.query_conv = nn.Sequential(conv1x1(ch, ch), nn.ReLU())
        self.key_conv = nn.Sequential(conv1x1(ch, ch), nn.ReLU())
        self.value_conv = nn.Sequential(conv1x1(ch, ch), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q, k, v = (conv(x).flatten(2) for conv in (self.query_conv, self.key_conv,
                                                   self.value_conv))  # (b, c, hw)
        att = torch.einsum('bci,bcj->bij', q, k).softmax(dim=-1)
        return torch.einsum('bij,bcj->bci', att, v).reshape(b, c, h, w)


class DDVNetDecoder(nn.Module):
    """Arguments as `MonodepthDecoder`'s (no kernel switches: no stage of this
    decoder is a fused stage). `out_act` is checked but not applied: the
    expectation over the bins is the output."""
    num_ch_dec = (16, 32, 64, 128, 256)
    num_bins = 128

    def __init__(self, num_ch_enc: Sequence[int], enc_sc: Sequence[int],
                 upsample_mode: str = 'nearest', use_skip: bool = True,
                 out_sc: Sequence[int] = (0, 1, 2, 3), out_ch: int = 1,
                 out_act: Optional[str] = 'sigmoid', pad_mode: str = 'reflect'):
        super().__init__()
        if out_act not in ACT:
            raise KeyError(f'Invalid activation key. ({out_act} vs. {tuple(ACT)})')
        self.enc_sc, self.use_skip = list(enc_sc), use_skip
        self.upsample_mode = upsample_mode
        self.out_sc, self.out_ch = list(out_sc), out_ch
        convs, self.idx = [SelfAttentionBlock(num_ch_enc[-1])], {}
        ch = num_ch_enc[-1]
        for i in range(4, -1, -1):
            self.idx[f'upconv_{i}_0'] = len(convs)
            convs.append(ConvBlock(ch, self.num_ch_dec[i], pad_mode))
            ch = self.num_ch_dec[i]
            if self._has_skip(i):
                ch += num_ch_enc[self.enc_sc.index(2 ** i)]
            self.idx[f'upconv_{i}_1'] = len(convs)
            convs.append(ConvBlock(ch, self.num_ch_dec[i], pad_mode))
            ch = self.num_ch_dec[i]
        for i in self.out_sc:
            self.idx[f'outconv_{i}'] = len(convs)
            convs.append(conv3x3(self.num_ch_dec[i], self.num_bins * out_ch, pad_mode))
        self.decoder = nn.ModuleList(convs)

    def _has_skip(self, i: int) -> bool:
        return self.use_skip and 2 ** i in self.enc_sc

    def unused_reference_keys(self) -> list[str]:
        """The reference's `bins` buffer (a constant)."""
        return ['bins']

    def expected_disparity(self, logits: torch.Tensor) -> torch.Tensor:
        """(b, out_ch * n_bins, h, w) logits -> (b, out_ch, h, w) expected disparity."""
        b, _, h, w = logits.shape
        probs = logits.reshape(b, self.out_ch, self.num_bins, h, w).softmax(dim=2)
        bins = get_discrete_bins(self.num_bins, device=logits.device, dtype=logits.dtype)
        return (probs * bins[:, None, None]).sum(dim=2)

    def forward(self, feat: list[torch.Tensor]) -> dict[int, torch.Tensor]:
        out = {}
        x = self.decoder[0](feat[-1])
        for i in range(4, -1, -1):
            x = [upsample2x(self.decoder[self.idx[f'upconv_{i}_0']](x), self.upsample_mode)]
            if self._has_skip(i):
                x.append(feat[self.enc_sc.index(2 ** i)])
            x = self.decoder[self.idx[f'upconv_{i}_1']](torch.cat(x, dim=1))
            if i in self.out_sc:
                out[i] = self.expected_disparity(self.decoder[self.idx[f'outconv_{i}']](x))
        return out
