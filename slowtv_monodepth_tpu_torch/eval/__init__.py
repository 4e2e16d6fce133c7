"""Offline depth evaluation (numpy and scipy; copies of the JAX package's
`eval/`): the metric collections, depth edges and `MonoDepthEvaluator`."""
from .edges import canny, extract_edges
from .evaluator import MonoDepthEvaluator
from .metrics import metrics_benchmark, metrics_eigen, metrics_ibims, metrics_pointcloud

__all__ = ['canny', 'extract_edges', 'MonoDepthEvaluator',
           'metrics_benchmark', 'metrics_eigen', 'metrics_ibims', 'metrics_pointcloud']
