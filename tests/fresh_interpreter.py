"""Run a piece of a test in a fresh Python interpreter.

The port's evaluator (`nproc > 0`) and its MapFreeReloc writer fan out over a
forked `multiprocessing.Pool`. A process of this suite has imported JAX,
whose thread pools a fork does not carry over: a forked child can deadlock
and hang its xdist worker until the suite's time limit ("os.fork() was
called ... JAX is multithreaded"). Such a test hands the forking part to
`run_fresh`: a subprocess of `sys.executable` at the repo root, with torch at
two threads as `torch_threads.py` sets them, that fails if JAX was imported
(`jax_free=False` for the JAX package's own scripts, which a subprocess then
keeps away from the worker) and is killed at its `timeout`. Imports no JAX.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from typing import Any, Optional

__all__ = ['REPO', 'run_fresh']

REPO = Path(__file__).resolve().parents[1]
_PRELUDE = '''
import pickle, sys
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
with open({inputs!r}, 'rb') as f:
    INPUTS = pickle.load(f)
OUTPUT = None
'''
_EPILOGUE = '''
if {jax_free!r}:
    assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules), 'JAX was imported'
with open({output!r}, 'wb') as f:
    pickle.dump(OUTPUT, f)
'''


def run_fresh(code: str, tmp_path: Path, inputs: Any = None, env: Optional[dict] = None,
              timeout: float = 300, jax_free: bool = True) -> Any:
    """Run `code` (it reads `INPUTS`, sets `OUTPUT`; both pickled) in a new
    interpreter -> OUTPUT. `env` adds environment variables (the data roots the
    test's fixtures made: a subprocess does not see their monkeypatches)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    files = {k: str(tmp_path / f'fresh_{k}.pkl') for k in ('inputs', 'output')}
    with open(files['inputs'], 'wb') as f:
        pickle.dump(inputs, f)
    script = (_PRELUDE.format(tests=str(REPO / 'tests'), **files) + textwrap.dedent(code)
              + _EPILOGUE.format(jax_free=jax_free, **files))
    out = subprocess.run([sys.executable, '-c', script], cwd=REPO, capture_output=True,
                         text=True, timeout=timeout, env={**os.environ, **(env or {})})
    assert out.returncode == 0, out.stderr[-4000:]
    with open(files['output'], 'rb') as f:
        return pickle.load(f)
