from .convnext_block import fused_convnext_block, fused_convnext_block_plain
from .decoder_stage import (fused_upconv_stage, fused_upconv_stage_bwd,
                            fused_upconv_stage_bwd_plain, fused_upconv_stage_plain)
from .dwconv import depthwise_conv, depthwise_conv_plain, dwconv_dw, dwconv_dw_plain
from .geometry import T_from_AAt, blend_stereo, resize_K, to_inv, to_scaled, view_synth
from .ops import (IMAGENET_MEAN, IMAGENET_STD, clip, eps, mean_normalize, resize,
                  resize_like, standardize, upsample2x_nearest)
from .photo import photo_bwd, photo_err_ssim, photo_fwd
from .sample import grid_sample, warp_bilinear, warp_bilinear_packed, warp_bilinear_plain

__all__ = ['fused_convnext_block', 'fused_convnext_block_plain', 'fused_upconv_stage',
           'fused_upconv_stage_plain', 'fused_upconv_stage_bwd',
           'fused_upconv_stage_bwd_plain', 'depthwise_conv', 'depthwise_conv_plain',
           'dwconv_dw', 'dwconv_dw_plain', 'T_from_AAt', 'blend_stereo',
           'resize_K', 'to_inv', 'to_scaled', 'view_synth', 'IMAGENET_MEAN',
           'IMAGENET_STD', 'clip', 'eps', 'mean_normalize', 'resize', 'resize_like',
           'standardize', 'upsample2x_nearest', 'photo_bwd', 'photo_err_ssim', 'photo_fwd',
           'grid_sample', 'warp_bilinear', 'warp_bilinear_packed', 'warp_bilinear_plain']
