"""On-device training metrics (the torchmetrics equivalents), PyTorch port.

Counterpart of `slowtv_monodepth_tpu/core/train_metrics.py` (ref
`src/utils/metrics.py:7-111` + `src/tools/parsers.py:272-280`): MAE, RMSE,
LogSI (scale-invariant in log depth), AbsRel (%), DeltaAcc<1.25, computed on
median-aligned depths over the valid pixels. Every value stays a device
tensor: no host sync.

The `DeltaAcc` denominator intentionally reproduces the reference's legacy
`thresh.nansum` (sum of ratio values, not a count, `metrics.py:108-110`) since
these monitors define comparability with published training curves.
"""
from __future__ import annotations

import torch

__all__ = ['compute_train_metrics', 'METRIC_NAMES']

METRIC_NAMES = ('MAE', 'RMSE', 'LogSI', 'AbsRel', 'Acc')


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row-wise mean over valid entries: (b, n) -> (b,)."""
    n = mask.sum(dim=1).clamp(min=1)
    return torch.where(mask, x, 0.0).sum(dim=1) / n


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row-wise median over valid entries: (b, n) -> (b,).

    Masked-out entries are pushed to +inf and the k-th order statistic is read
    at k = (count-1)/2 (interpolating even counts), matching `nanmedian`; 1.0
    where a row has no valid entry.
    """
    xs = torch.sort(torch.where(mask, x, torch.inf), dim=1).values
    cnt = mask.sum(dim=1)
    lo = ((cnt - 1) // 2).clamp(min=0)
    hi = (cnt // 2).clamp(min=0)

    def take(idx):
        return xs.gather(1, idx[:, None])[:, 0]

    med = 0.5 * (take(lo) + take(hi))
    return torch.where(cnt > 0, med, 1.0)


def compute_train_metrics(pred: torch.Tensor, target: torch.Tensor,
                          min_depth: float = 0.1, max_depth: float = 100.0) -> dict:
    """Median-aligned batch depth metrics (ref `src/core/trainer.py:531-552`).

    :param pred: (b, h, w, 1) scaled depth prediction (already at GT shape or
        resized by the caller).
    :param target: (b, h, w, 1) ground-truth depth (0/neg = invalid).
    :return: {name: scalar tensor} averaged over the batch.
    """
    b = pred.shape[0]
    pred = pred.reshape(b, -1).clamp(min_depth, max_depth)
    target = target.reshape(b, -1)
    mask = (target > min_depth) & (target < max_depth)

    r = _masked_median(target, mask) / _masked_median(pred, mask)
    pred = (pred * r[:, None]).clamp(min_depth, max_depth)
    target = target.clamp(min_depth, max_depth)

    err = pred - target
    abs_err = err.abs()

    mae = _masked_mean(abs_err, mask)
    rmse = _masked_mean(err ** 2, mask).sqrt()

    log_err = pred.log() - target.log()
    log_si = (_masked_mean(log_err ** 2, mask) - _masked_mean(log_err, mask) ** 2).clamp(min=0).sqrt()

    abs_rel = _masked_mean(abs_err / target, mask)

    thresh = torch.maximum(target / pred, pred / target)
    # Legacy denominator: sum of thresh over valid pixels (see module docstring).
    acc = ((mask & (thresh < 1.25)).sum(dim=1)
           / torch.where(mask, thresh, 0.0).sum(dim=1).clamp(min=1.0))

    return {
        'MAE': mae.mean(),
        'RMSE': rmse.mean(),
        'LogSI': 100.0 * log_si.mean(),
        'AbsRel': 100.0 * abs_rel.mean(),
        'Acc': 100.0 * acc.mean(),
    }
