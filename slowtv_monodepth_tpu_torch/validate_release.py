"""One-command release validation: checkpoints + data roots in, BASELINE diff out
(PyTorch port).

Counterpart of the JAX package's `api/eval/validate_release.py`. It makes the
accuracy claim executable (BASELINE.json: "SYNS-Patches AbsRel / F-Score
within 1% of reference checkpoints"): given released checkpoint(s) and data
roots (`PATHS.yaml` / `SLOWTV_DATA_ROOTS`), it runs the whole chain,
`export_preds` (on `--device`, default `cuda`) -> `eval_depth` (lsqr and
median), over the eval matrix, writes the per-dataset metric YAMLs in the
reference's `results/` layout (`syns_test_last_lsqr.yaml`), and diffs the
seed-averaged metrics against the published baselines
(`cfg/validate/baselines.yaml`).

Exit status: 0 = every gated metric within tolerance, 1 = some deviation
exceeds it, 3 = nothing could be evaluated (no data roots resolved).

    slowtv-validate-release-torch --ckpt kbr_042.ckpt kbr_195.ckpt kbr_335.ckpt \\
        --model kbr/base --out /tmp/validation

A reference Lightning `.ckpt` file is read as it is (`core.checkpoint`); a
run directory resolves to its `models/<ckpt-name>.ckpt`. Datasets whose data
(or exported GT targets) are missing are reported as SKIPPED and do not
gate; `--require-data` turns them into failures.

`--preds` runs in preds-only mode: pre-computed prediction NPZs (e.g. the
reference's released predictions) skip the prediction half and validate only
the evaluator, alignment and metrics against the published baselines:

    slowtv-validate-release-torch --preds /data/released_preds --out /tmp/val

Two repairs of the JAX script: a directory's `<ds>_*.npz` fallback never
binds a dataset to a file named after another dataset (`kitti_eigen` to
`kitti_eigen_benchmark.npz`), and the file each dataset resolved to is
logged; `--preds` together with `--ckpt` is refused (the JAX script averages
the released predictions into the checkpoints' seed mean).
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from . import LOGGER
from .config import load_yaml, save_yaml
from .eval_depth import compute_eval_metrics, save_metrics
from .export_preds import compute_preds, save_preds
from .paths import REPO_ROOT
from .tools import TableFormatter

__all__ = ['main']

EVAL_CFGS = REPO_ROOT / 'cfg' / 'eval'

# Higher-is-better metrics (for the diff table's "better/worse" direction;
# mirrors the reference's table highlighting, `generate_tables.py` order=1
# columns). Everything else is lower-is-better.
HIGHER_BETTER = ('F-Score', 'IoU', 'delta', '$\\delta', 'Acc')


def _is_higher_better(metric: str) -> bool:
    return any(s in metric for s in HIGHER_BETTER)


def _resolve_ckpt(ckpt: Path, ckpt_name: str = 'last') -> Path:
    """A released checkpoint -> the file the predictor loads: a `.ckpt` file
    (the reference's Lightning files load as they are) or a run directory's
    `models/<ckpt_name>.ckpt`."""
    ckpt = Path(ckpt)
    if ckpt.is_file():
        return ckpt
    for f in (ckpt / 'models' / f'{ckpt_name}.ckpt', ckpt / f'{ckpt_name}.ckpt'):
        if f.is_file():
            return f
    raise FileNotFoundError(f'No checkpoint file at "{ckpt}" (nor its '
                            f'models/{ckpt_name}.ckpt).')


def _names_a_sibling(stem: str, ds: str, known) -> bool:
    """Whether `<ds>_*` file `stem` is named after another dataset: one whose
    name extends `ds` (`kitti_eigen_benchmark` for `kitti_eigen`)."""
    return any(o != ds and o.startswith(f'{ds}_') and (stem == o or stem.startswith(f'{o}_'))
               for o in known)


def _find_released_preds(preds_args: list, datasets: list, known=()) -> dict:
    """`--preds` values -> {dataset: npz path}.

    Accepts explicit `dataset=path.npz` pairs and/or directories searched for
    `<dataset>.npz`, else `<dataset>_*.npz` (the reference's released-prediction
    naming, `np.savez_compressed(file, pred=preds)`) that is not named after
    another dataset of `datasets` or `known`. Missing datasets are absent
    (reported SKIPPED).
    """
    known = set(datasets) | set(known)
    preds_map: dict = {}
    dirs = []
    for item in preds_args:
        if '=' in str(item) and not Path(item).exists():
            ds, _, path = str(item).partition('=')
            preds_map[ds] = Path(path)
        elif Path(item).is_dir():
            dirs.append(Path(item))
        else:
            raise FileNotFoundError(f'--preds entry "{item}" is neither a '
                                    f'directory nor a dataset=path pair')
    for ds in datasets:
        if ds in preds_map:
            continue
        for d in dirs:
            hits = sorted(d.glob(f'{ds}.npz')) or [
                f for f in sorted(d.glob(f'{ds}_*.npz'))
                if not _names_a_sibling(f.stem, ds, known)]
            if hits:
                preds_map[ds] = hits[0]
                break
    for ds, f in preds_map.items():
        LOGGER.info(f'Released predictions for "{ds}": {f}')
    return preds_map


def _evaluate_seed(ckpt_path, datasets: list, aligns: list, out_dir: Path,
                   ckpt_name: str, args, preds_map: dict = None) -> dict:
    """One checkpoint over the eval matrix -> {(dataset, align): metrics}.

    :param preds_map: preds-only mode: {dataset: npz of released predictions};
        the prediction half is skipped and only the evaluator, alignment and
        metrics run.
    """
    results: dict = {}
    for ds in datasets:
        cfg_file = EVAL_CFGS / f'{ds}.yaml'
        if not cfg_file.is_file():
            raise FileNotFoundError(f'No eval cfg for dataset "{ds}" ({cfg_file})')
        pred_file = out_dir / 'preds' / f'{ds}_{ckpt_name}.npz'
        try:
            if preds_map is not None:
                if ds not in preds_map:
                    raise FileNotFoundError(f'no released predictions for "{ds}" in --preds')
                preds = np.load(preds_map[ds])['pred']
            elif pred_file.is_file() and not args.overwrite:
                preds = np.load(pred_file)['pred']
            else:
                cfg_ds = load_yaml(cfg_file)['dataset']
                preds = compute_preds(
                    cfg_ds, str(ckpt_path), overwrite=True,
                    batch_size=args.batch_size, num_workers=args.num_workers,
                    devices=args.devices, device=args.device)
                save_preds(pred_file, preds)
            for align in aligns:
                mean_metrics, _ = compute_eval_metrics(
                    preds, cfg_file, align, nproc=args.nproc, max_items=args.max_items)
                save_file = out_dir / 'results' / f'{ds}_{ckpt_name}_{align}.yaml'
                save_metrics(save_file, mean_metrics)
                results[(ds, align)] = mean_metrics
        except FileNotFoundError as e:
            if args.require_data:
                raise
            LOGGER.warning(f'SKIP {ds}: data/targets missing ({e})')
            results[(ds, None)] = None
    return results


def _diff_rows(mean: dict, baseline: dict, ckpt_name: str, gate: list,
               tolerance: float) -> list:
    """[(dataset, align, metric, ours, ref, dev_pct, status)] per gated metric."""
    rows = []
    for (ds, align), metrics in sorted(mean.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        if metrics is None:
            rows.append((ds, '-', '-', None, None, None, 'SKIPPED'))
            continue
        base = (baseline.get(ds, {}).get(ckpt_name, {}) or {}).get(align)
        if not base:
            rows.append((ds, align, '-', None, None, None, 'NO-BASELINE'))
            continue
        for metric in gate:
            ref = base.get(metric)
            ours = metrics.get(metric)
            if ref is None or ours is None:
                continue
            dev = 100.0 * (float(ours) - float(ref)) / abs(float(ref))
            ok = abs(dev) <= tolerance
            status = 'PASS' if ok else (
                'FAIL (better)' if (dev < 0) != _is_higher_better(metric) else 'FAIL')
            rows.append((ds, align, metric, float(ours), float(ref), dev, status))
    return rows


def main() -> int:
    parser = ArgumentParser(description=__doc__.split('\n', 1)[0])
    parser.add_argument('--ckpt', nargs='+', type=Path, default=None,
                        help='Released checkpoint(s): .ckpt files (the reference\'s '
                             'Lightning files load as they are) or run dirs. Multiple = '
                             'seeds, metrics averaged (the baselines are 3-seed means). '
                             'Required unless --preds is given.')
    parser.add_argument('--preds', nargs='+', default=None,
                        help='Preds-only mode: pre-computed prediction NPZs (the '
                             'reference\'s released predictions) as directories and/or '
                             'dataset=path pairs. Skips the prediction half and validates '
                             'only the evaluator/alignment/metric stack against the '
                             'published baselines. Not with --ckpt.')
    parser.add_argument('--model', default='kbr/base',
                        help='Baseline key (<exp>/<model>) to diff against.')
    parser.add_argument('--ckpt-name', default='last', choices=('last', 'best'),
                        help='Checkpoint flavor for result-YAML naming and baseline lookup.')
    parser.add_argument('--datasets', nargs='*', default=None,
                        help='Eval datasets (default: every dataset with a baseline entry '
                             'for --model).')
    parser.add_argument('--align', nargs='*', default=['lsqr', 'median'])
    parser.add_argument('--baselines', type=Path,
                        default=REPO_ROOT / 'cfg' / 'validate' / 'baselines.yaml')
    parser.add_argument('--tolerance', type=float, default=1.0,
                        help='Max |relative deviation| in percent per gated metric '
                             '(BASELINE.json: 1%%).')
    parser.add_argument('--gate', nargs='*', default=['AbsRel', 'F-Score (10)'],
                        help='Metrics that gate the exit status.')
    parser.add_argument('--out', type=Path, required=True,
                        help='Output dir: per-seed results/ YAMLs + report.')
    parser.add_argument('--require-data', action='store_true',
                        help='Fail (instead of skip) on missing data roots.')
    parser.add_argument('--overwrite', action='store_true')
    parser.add_argument('--batch-size', type=int, default=12)
    parser.add_argument('--num-workers', type=int, default=8)
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'.")
    parser.add_argument('--devices', type=int, default=1, help='> 1: ROADMAP A11.')
    parser.add_argument('--nproc', type=int, default=None)
    parser.add_argument('--max-items', type=int, default=None)
    args = parser.parse_args()

    baselines = load_yaml(args.baselines)
    if args.model not in baselines:
        raise SystemExit(f'No baselines for model "{args.model}" in '
                         f'{args.baselines} (have: {sorted(baselines)})')
    baseline = baselines[args.model]
    datasets = args.datasets or [d for d in sorted(baseline) if d != '_seeds'
                                 and args.ckpt_name in baseline[d]]

    if not args.ckpt and not args.preds:
        parser.error('one of --ckpt / --preds is required')
    if args.ckpt and args.preds:
        parser.error('--preds and --ckpt cannot be mixed: the released predictions would be '
                     'averaged into the checkpoints\' seed mean. Validate them in two runs.')

    args.out.mkdir(parents=True, exist_ok=True)
    per_seed = []
    if args.preds:
        known = [f.stem for f in EVAL_CFGS.glob('*.yaml')] + list(baseline)
        preds_map = _find_released_preds(args.preds, datasets, known)
        LOGGER.info(f'=== Preds-only: {len(preds_map)}/{len(datasets)} '
                    f'datasets have released predictions ===')
        per_seed.append(_evaluate_seed(None, datasets, args.align, args.out / 'preds_only',
                                       args.ckpt_name, args, preds_map=preds_map))
    for i, ckpt in enumerate(args.ckpt or ()):
        seed_dir = args.out / f'seed_{i:03d}'
        ckpt_path = _resolve_ckpt(ckpt, args.ckpt_name)
        LOGGER.info(f'=== Seed {i}: {ckpt_path} over {datasets} ===')
        per_seed.append(_evaluate_seed(ckpt_path, datasets, args.align, seed_dir,
                                       args.ckpt_name, args))

    # Seed-average (the baselines are means over the published seeds).
    mean: dict = {}
    for key in {k for seed in per_seed for k in seed}:
        vals = [s[key] for s in per_seed if s.get(key) is not None]
        if not vals:
            mean[key] = None
            continue
        mean[key] = {m: float(np.mean([v[m] for v in vals]))
                     for m in vals[0] if isinstance(vals[0][m], (int, float))}

    rows = _diff_rows(mean, baseline, args.ckpt_name, args.gate, args.tolerance)
    evaluated = [r for r in rows if r[6] not in ('SKIPPED', 'NO-BASELINE')]
    failed = [r for r in evaluated if r[6].startswith('FAIL')]

    body = [[f'{r[3]:.3f}' if r[3] is not None else '-',
             f'{r[4]:.3f}' if r[4] is not None else '-',
             f'{r[5]:+.2f}%' if r[5] is not None else '-',
             r[6]] for r in rows]
    table = TableFormatter(
        header=['ours', 'reference', 'deviation', 'status'],
        labels=[f'{r[0]} {r[1]} {r[2]}' for r in rows], body=body,
        title=f'{args.model} ({args.ckpt_name}, tol {args.tolerance}%)')
    print(table.to_markdown())

    report = {
        'model': args.model, 'ckpt_name': args.ckpt_name,
        'tolerance_pct': args.tolerance, 'gate': args.gate,
        'n_seeds': len(per_seed),
        'preds_only': bool(args.preds) and not args.ckpt,
        'rows': [{'dataset': r[0], 'align': r[1], 'metric': r[2],
                  'ours': r[3], 'reference': r[4], 'deviation_pct': r[5],
                  'status': r[6]} for r in rows],
        'n_evaluated': len(evaluated), 'n_failed': len(failed),
        'passed': bool(evaluated) and not failed,
    }
    report_file = args.out / 'validation_report.yaml'
    save_yaml(report_file, report)
    LOGGER.info(f'Report -> {report_file}')

    if not evaluated:
        LOGGER.error('Nothing evaluated: no dataset had both data and a baseline entry. '
                     'Provision data roots (PATHS.yaml) and exported GT targets '
                     '(slowtv-export-gt-torch).')
        return 3
    if failed:
        LOGGER.error(f'{len(failed)}/{len(evaluated)} gated metrics deviate '
                     f'>{args.tolerance}% from the reference.')
        return 1
    LOGGER.info(f'All {len(evaluated)} gated metrics within {args.tolerance}% of the reference.')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
