from .viz import apply_cmap, rgb_from_disp

__all__ = ['apply_cmap', 'rgb_from_disp']
