"""Aggregate per-seed result YAMLs into averaged LaTeX/Markdown tables (PyTorch port).

Copy of `api/eval/generate_tables.py` (ref `api/eval/generate_tables.py:11-209`),
with pandas and yaml imported inside the functions that use them: glob result
YAMLs per experiment/seed, normalize legacy metric names (`F-Score` ->
`F-Score (10)`, `$\\delta < 1.25$` -> `$\\delta_{.25}$` x100), average over
seeds with stddev, and print via TableFormatter.

Usage:
    slowtv-tables-torch --root models --exp kbr --dataset syns_test --ckpt last --mode lsqr
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path
from typing import Optional

from .tools import TableFormatter

__all__ = ['get_models', 'load_dfs', 'filter_df', 'get_df_mean', 'main']

DELTA, DELTA_LEGACY = '$\\delta_{.25}$', '$\\delta < 1.25$'
F, F_LEGACY = 'F-Score (10)', 'F-Score'


def get_models(root: Path, exp: str, dataset: str, ckpt: str = 'last',
               mode: str = '*', res: str = 'results',
               models: Optional[list] = None, tag: str = ''):
    """Map model names -> their per-seed result files."""
    if isinstance(models, str):
        models = models.split()
    fname = f'{dataset}_{ckpt}_{mode}.yaml'

    if not models:
        fs = sorted(root.glob(f'{exp}/**/{res}/{fname}'))
        models = sorted({file.parents[2].stem for file in fs})

    print('Evaluation Models:', models)
    eval_files = {m + tag: sorted(root.glob(f'{exp}/{m}/**/{res}/{fname}')) for m in models}
    eval_files = {k: v for k, v in eval_files.items() if v}
    return eval_files, list(eval_files)


def load_dfs(files: dict) -> 'pd.DataFrame':  # noqa: F821
    import pandas as pd
    import yaml
    rows, index = [], []
    for model, fs in files.items():
        for i, f in enumerate(fs):
            with open(f) as fh:
                rows.append(yaml.safe_load(fh))
            index.append((model, i))
    df = pd.json_normalize(rows)
    df.index = pd.MultiIndex.from_tuples(index, names=['Model', 'Item'])
    return df


def filter_df(df: 'pd.DataFrame'):  # noqa: F821
    """Keep AbsRel + (F-Score or delta), merging legacy columns."""
    metrics, metric_type = ['AbsRel'], [-1]

    if F_LEGACY in df and F not in df:
        df = df.rename(columns={F_LEGACY: F})
    if DELTA_LEGACY in df and DELTA not in df:
        df[DELTA] = 100 * df[DELTA_LEGACY]
        df = df.drop(columns=[DELTA_LEGACY])

    if F in df:
        metrics.append(F)
        metric_type.append(+1)
        if F_LEGACY in df:
            df[F] = df[F].fillna(0) + df[F_LEGACY].fillna(0)
    elif DELTA in df:
        metrics.append(DELTA)
        metric_type.append(+1)
        if DELTA_LEGACY in df:
            df[DELTA] = df[DELTA].fillna(0) + 100 * df[DELTA_LEGACY].fillna(0)

    df = df[metrics].rename(columns={'AbsRel': 'Rel', F: 'F', DELTA: 'delta'})
    return df, metric_type


def get_df_mean(df: 'pd.DataFrame', models: list, name: str = 'Mean'):  # noqa: F821
    g = df.groupby(level=0)
    df_mean = g.agg('mean').reindex(models)
    df_std = g.agg('std').reindex(models)
    df_mean.columns.name = name
    df_std.columns.name = 'StdDev'
    return df_mean, df_std


def main():
    parser = ArgumentParser()
    parser.add_argument('--root', type=Path, required=True)
    parser.add_argument('--exp', type=str, required=True)
    parser.add_argument('--dataset', type=str, required=True)
    parser.add_argument('--ckpt', default='last')
    parser.add_argument('--mode', default='*')
    parser.add_argument('--models', nargs='*', default=None)
    parser.add_argument('--precision', type=int, default=2)
    parser.add_argument('--fmt', default='markdown', choices=['markdown', 'latex'])
    args = parser.parse_args()

    files, models = get_models(args.root, args.exp, args.dataset,
                               ckpt=args.ckpt, mode=args.mode, models=args.models)
    if not files:
        raise SystemExit(f'No result files found under {args.root}/{args.exp}.')
    df, metric_type = filter_df(load_dfs(files))
    df_mean, df_std = get_df_mean(df, models, name=f'{args.exp}/{args.dataset}')

    t = TableFormatter.from_df(df_mean, metrics=metric_type)
    print(t.to_latex(precision=args.precision) if args.fmt == 'latex'
          else t.to_markdown(precision=args.precision))
    print('\nStdDev:')
    print(TableFormatter.from_df(df_std).to_markdown(precision=args.precision))


if __name__ == '__main__':
    main()
