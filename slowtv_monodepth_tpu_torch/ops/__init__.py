from .decoder_stage import fused_upconv_stage, fused_upconv_stage_plain
from .dwconv import depthwise_conv, depthwise_conv_plain
from .geometry import blend_stereo, to_inv, to_scaled
from .ops import IMAGENET_MEAN, IMAGENET_STD, resize, standardize, upsample2x_nearest

__all__ = ['fused_upconv_stage', 'fused_upconv_stage_plain', 'depthwise_conv',
           'depthwise_conv_plain', 'blend_stereo', 'to_inv', 'to_scaled',
           'IMAGENET_MEAN', 'IMAGENET_STD', 'resize', 'standardize',
           'upsample2x_nearest']
