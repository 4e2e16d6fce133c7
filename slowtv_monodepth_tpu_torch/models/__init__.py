from .autoencoder import AutoencoderNet
from .depth import DepthNet, seeded_state_dict
from .from_jax import (autoencoder_state_dict_from_jax, depth_state_dict_from_jax,
                       pose_state_dict_from_jax)
from .pose import PoseNet

__all__ = ['AutoencoderNet', 'DepthNet', 'PoseNet', 'seeded_state_dict',
           'autoencoder_state_dict_from_jax', 'depth_state_dict_from_jax',
           'pose_state_dict_from_jax']
