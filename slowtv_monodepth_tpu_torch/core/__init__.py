from .checkpoint import load_checkpoint, net_state_dict, save_checkpoint
from .predictors import BenchmarkPredictor, MonoDepthPredictor

__all__ = ['load_checkpoint', 'net_state_dict', 'save_checkpoint',
           'BenchmarkPredictor', 'MonoDepthPredictor']
