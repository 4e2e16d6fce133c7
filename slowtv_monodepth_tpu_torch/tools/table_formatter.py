"""Results -> LaTeX/Markdown tables with best-value highlighting.

Equivalent capability to the reference `src/tools/table_formatter.py:18-305`:
`from_dict`/`from_df`/`from_files` constructors, per-column better-direction
metadata (+1 higher-better / -1 lower-better), best (`\\best{}`) and
second-best (`\\nbest{}`) highlighting in LaTeX `booktabs` output, and
bold/italic highlighting in Markdown. Copy of
`slowtv_monodepth_tpu/tools/table_formatter.py` (yaml imported inside
`from_files`).
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import numpy as np

__all__ = ['TableFormatter']


def _default_key(file: Path) -> str:
    return Path(file).stem


class TableFormatter:
    """:param header: (m,) Column names.
    :param labels: (n,) Row names (or lists of str joined by spaces).
    :param body: (n, m) Table values.
    :param metrics: (m,)|scalar +1/-1 per column: is higher better? None
        disables highlighting.
    :param title: Upper-left corner text.
    """

    def __init__(self, header: Sequence[str], labels: Sequence,
                 body, metrics: Optional[Union[int, Sequence[int]]] = None,
                 title: Optional[str] = None):
        self.header = list(header)
        self.labels = [' '.join(l) if not isinstance(l, str) else l for l in labels]
        self.body = np.asarray(body, dtype=object)
        self.title = title or ''

        m = len(self.header)
        if metrics is None:
            self.metrics = np.zeros(m, dtype=int)
        elif isinstance(metrics, int):
            self.metrics = np.full(m, metrics, dtype=int)
        else:
            self.metrics = np.asarray(metrics, dtype=int)
            if len(self.metrics) != m:
                raise ValueError(f'Metric type mismatch. ({len(self.metrics)} vs. {m})')

        if self.body.shape != (len(self.labels), m):
            raise ValueError(f'Shape mismatch. ({self.body.shape} vs. '
                             f'{(len(self.labels), m)})')

        self.best_mask, self.nbest_mask = self._get_best()

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_dict(cls, data: dict, metrics=None, title: Optional[str] = None):
        """Single-row table from a {metric: value} dict."""
        items = [(k, v) for k, v in data.items() if isinstance(v, (int, float))]
        return cls(header=[k for k, _ in items], labels=[''],
                   body=[[v for _, v in items]], metrics=metrics, title=title)

    @classmethod
    def from_df(cls, df, metrics=None):
        return cls(header=list(df.columns), labels=list(df.index),
                   body=df.to_numpy(), metrics=metrics,
                   title=getattr(df.columns, 'name', None))

    @classmethod
    def from_files(cls, files: Sequence, key: Callable = _default_key, metrics=None):
        """Table from YAML result files: one row per file."""
        import yaml
        if not files:
            raise ValueError('Must provide files to create table.')
        rows = []
        for f in files:
            with open(f) as fh:
                rows.append(yaml.safe_load(fh))
        return cls(header=list(rows[0]), labels=[key(f) for f in files],
                   body=[[r.get(h) for h in rows[0]] for r in rows], metrics=metrics)

    # ----------------------------------------------------------------- helpers
    @property
    def shape(self) -> tuple:
        return len(self.labels), len(self.header)

    def _numeric(self) -> np.ndarray:
        out = np.full(self.body.shape, np.nan)
        for i in range(self.body.shape[0]):
            for j in range(self.body.shape[1]):
                v = self.body[i, j]
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[i, j] = v
        return out

    def _get_best(self):
        """Boolean masks of best/second-best value per column."""
        vals = self._numeric()
        best = np.zeros(vals.shape, bool)
        nbest = np.zeros(vals.shape, bool)
        if vals.shape[0] < 2:
            return best, nbest
        for j, m in enumerate(self.metrics):
            if m == 0:
                continue
            col = vals[:, j] * (1 if m > 0 else -1)
            order = np.argsort(-col)
            order = [i for i in order if np.isfinite(col[i])]
            if order:
                best[order[0], j] = True
            if len(order) > 1:
                nbest[order[1], j] = True
        return best, nbest

    def _fmt(self, v, precision: int) -> str:
        if isinstance(v, float):
            return f'{v:.{precision}f}'
        return str(v)

    # ------------------------------------------------------------------ output
    def to_latex(self, precision: int = 2, highlight: bool = True) -> str:
        """Booktabs LaTeX table; best -> `\\best{}`, 2nd -> `\\nbest{}`."""
        arrows = {1: '\\up', -1: '\\down', 0: ''}
        header = [self.title] + [f'{h}{arrows[m]}' for h, m in zip(self.header, self.metrics)]
        lines = [
            '\\begin{tabular}{l' + 'c' * len(self.header) + '}',
            '\\toprule',
            ' & '.join(header) + ' \\\\',
            '\\midrule',
        ]
        for i, label in enumerate(self.labels):
            cells = []
            for j in range(len(self.header)):
                s = self._fmt(self.body[i, j], precision)
                if highlight and self.best_mask[i, j]:
                    s = f'\\best{{{s}}}'
                elif highlight and self.nbest_mask[i, j]:
                    s = f'\\nbest{{{s}}}'
                cells.append(s)
            lines.append(' & '.join([label] + cells) + ' \\\\')
        lines += ['\\bottomrule', '\\end{tabular}']
        return '\n'.join(lines)

    def to_markdown(self, precision: int = 2, highlight: bool = True) -> str:
        """GitHub-flavored Markdown; best -> bold, 2nd -> italic."""
        arrows = {1: ' ↑', -1: ' ↓', 0: ''}
        header = [self.title] + [f'{h}{arrows[m]}' for h, m in zip(self.header, self.metrics)]
        lines = [
            '| ' + ' | '.join(header) + ' |',
            '|' + '---|' * (len(self.header) + 1),
        ]
        for i, label in enumerate(self.labels):
            cells = []
            for j in range(len(self.header)):
                s = self._fmt(self.body[i, j], precision)
                if highlight and self.best_mask[i, j]:
                    s = f'**{s}**'
                elif highlight and self.nbest_mask[i, j]:
                    s = f'*{s}*'
                cells.append(s)
            lines.append('| ' + ' | '.join([label] + cells) + ' |')
        return '\n'.join(lines)

    def __str__(self) -> str:
        return self.to_markdown()
