from .photometric import DenseL1Error, PhotoError, avg_pool3x3_reflect
from .reconstruction import ReconstructionLoss
from .regularizers import SmoothReg, compute_grad

__all__ = ['DenseL1Error', 'PhotoError', 'avg_pool3x3_reflect',
           'ReconstructionLoss', 'SmoothReg', 'compute_grad']
