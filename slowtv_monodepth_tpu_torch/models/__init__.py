from .depth import DepthNet, seeded_state_dict
from .from_jax import depth_state_dict_from_jax

__all__ = ['DepthNet', 'seeded_state_dict', 'depth_state_dict_from_jax']
