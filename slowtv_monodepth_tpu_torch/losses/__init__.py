from .photometric import DenseL1Error, DenseL2Error, PhotoError, avg_pool3x3_reflect
from .reconstruction import ReconstructionLoss
from .regression import RegressionLoss, berhu_loss, l1_loss, log_l1_loss
from .regularizers import (FeatPeakReg, FeatSmoothReg, MaskReg, OccReg, SmoothReg, compute_grad,
                           compute_laplacian)

__all__ = ['DenseL1Error', 'DenseL2Error', 'PhotoError', 'avg_pool3x3_reflect',
           'ReconstructionLoss', 'RegressionLoss', 'l1_loss', 'log_l1_loss', 'berhu_loss',
           'SmoothReg', 'FeatPeakReg', 'FeatSmoothReg', 'OccReg', 'MaskReg', 'compute_grad',
           'compute_laplacian']
