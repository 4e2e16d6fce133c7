from .checkpoint import (AsyncSaver, CheckpointManager, get_latest_ckpt, load_checkpoint,
                         load_net, net_state_dict, restore_checkpoint, save_checkpoint,
                         train_state_from_jax)
from .heavy_logger import HeavyLogger, make_grid
from .loop import MonoDepthLoop, TrainingManager
from .predictors import BenchmarkPredictor, MonoDepthPredictor
from .trainer import MonoDepthTrainer

__all__ = ['AsyncSaver', 'CheckpointManager', 'get_latest_ckpt', 'load_checkpoint',
           'load_net', 'net_state_dict', 'restore_checkpoint', 'save_checkpoint',
           'train_state_from_jax', 'HeavyLogger', 'make_grid', 'MonoDepthLoop',
           'TrainingManager', 'BenchmarkPredictor', 'MonoDepthPredictor', 'MonoDepthTrainer']
