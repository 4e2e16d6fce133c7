from .viz import apply_cmap, rgb_from_disp, rgb_from_feat

__all__ = ['apply_cmap', 'rgb_from_disp', 'rgb_from_feat']
