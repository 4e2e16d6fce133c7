from .table_formatter import TableFormatter
from .viz import apply_cmap, rgb_from_disp, rgb_from_feat

__all__ = ['TableFormatter', 'apply_cmap', 'rgb_from_disp', 'rgb_from_feat']
