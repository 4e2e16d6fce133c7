from .depth import DepthNet, seeded_state_dict
from .from_jax import depth_state_dict_from_jax, pose_state_dict_from_jax
from .pose import PoseNet

__all__ = ['DepthNet', 'PoseNet', 'seeded_state_dict', 'depth_state_dict_from_jax',
           'pose_state_dict_from_jax']
