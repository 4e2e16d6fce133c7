from .checkpoint import (CheckpointManager, get_latest_ckpt, load_checkpoint, net_state_dict,
                         restore_checkpoint, save_checkpoint, train_state_from_jax)
from .loop import MonoDepthLoop, TrainingManager
from .predictors import BenchmarkPredictor, MonoDepthPredictor
from .trainer import MonoDepthTrainer

__all__ = ['CheckpointManager', 'get_latest_ckpt', 'load_checkpoint', 'net_state_dict',
           'restore_checkpoint', 'save_checkpoint', 'train_state_from_jax', 'MonoDepthLoop',
           'TrainingManager', 'BenchmarkPredictor', 'MonoDepthPredictor', 'MonoDepthTrainer']
