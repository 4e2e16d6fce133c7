from .misc import flatten_dict, get_logger
from .timers import MultiLevelTimer

__all__ = ['flatten_dict', 'get_logger', 'MultiLevelTimer']
