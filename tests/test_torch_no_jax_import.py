"""The port imports nothing of JAX and nothing of the JAX package.

Two checks: every import statement of every module of
`slowtv_monodepth_tpu_torch/` and of `chip_smoke.py`, read with `ast`
(imports inside functions included), and the modules a fresh interpreter
holds after importing the whole port. The card's machine has no PIL, cv2,
scipy, yaml or matplotlib either, so no module imports those at its top
level (only inside the functions that use them).
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
from torch_threads import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'slowtv_monodepth_tpu_torch'
FILES = sorted(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py']
BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'slowtv_monodepth_tpu')


def banned_imports(source: str) -> list[str]:
    """Absolute imports of a banned top-level package in `source`."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        found += [n for n in names if n.split('.')[0] in BANNED]
    return found


@pytest.mark.parametrize('file', FILES, ids=lambda f: str(f.relative_to(ROOT)))
def test_no_banned_import_statement(file):
    assert banned_imports(file.read_text()) == []


def test_every_port_module_is_walked():
    names = {f.relative_to(ROOT).as_posix() for f in FILES}
    assert {'slowtv_monodepth_tpu_torch/core/loop.py', 'slowtv_monodepth_tpu_torch/train.py',
            'slowtv_monodepth_tpu_torch/data/loader.py',
            'slowtv_monodepth_tpu_torch/models/autoencoder.py', 'chip_smoke.py',
            'slowtv_monodepth_tpu_torch/models/encoders/vit.py',
            'slowtv_monodepth_tpu_torch/models/midas.py',
            'slowtv_monodepth_tpu_torch/models/import_midas.py',
            *(f'slowtv_monodepth_tpu_torch/models/decoders/{d}.py' for d in (
                'hrdepth', 'ddvnet', 'diffnet', 'cadepth', 'superdepth', 'dpt'))} <= names


@pytest.mark.parametrize('source,want', [
    ('import jax', ['jax']),
    ('def f():\n    import jax.numpy as jnp', ['jax.numpy']),
    ('from flax import linen', ['flax']),
    ('from slowtv_monodepth_tpu.config import load_merge_yaml', ['slowtv_monodepth_tpu.config']),
    ('import slowtv_monodepth_tpu', ['slowtv_monodepth_tpu']),
    ('from slowtv_monodepth_tpu_torch import parsers\nfrom . import jax_free', []),
])
def test_the_walker_has_teeth(source, want):
    assert banned_imports(source) == want


def test_importing_the_whole_port_loads_no_jax():
    """A fresh interpreter imports every module of the port; afterwards no
    banned package is in `sys.modules`."""
    mods = [f.relative_to(ROOT).with_suffix('').as_posix().replace('/', '.')
            for f in FILES[:-1]]
    mods = [m[:-len('.__init__')] if m.endswith('.__init__') else m for m in mods]
    code = ('import importlib, sys\n'
            f'for m in {mods!r}:\n    importlib.import_module(m)\n'
            f'bad = sorted(m for m in sys.modules if m.split(".")[0] in {BANNED!r})\n'
            'print("LOADED", bad)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == 'LOADED []'


HOST_ONLY = ('PIL', 'cv2', 'scipy', 'yaml', 'matplotlib')


def top_level_imports(source: str) -> list[str]:
    """Top-level packages imported by `source` outside any function."""
    found = []
    for node in ast.parse(source).body:
        if isinstance(node, ast.Import):
            found += [a.name.split('.')[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append((node.module or '').split('.')[0])
    return found


def test_no_module_imports_a_host_only_package_at_its_top():
    bad = {f.relative_to(ROOT).as_posix(): hits for f in FILES
           if (hits := sorted(set(top_level_imports(f.read_text())) & set(HOST_ONLY)))}
    assert bad == {}
    assert top_level_imports('import cv2\nfrom PIL import Image\ndef f():\n    import scipy') == [
        'cv2', 'PIL']
