"""`pyproject.toml` ships every package of the port.

A package missing from `[tool.setuptools] packages` installs without its
modules, and a non-editable install then fails at the first import of it
(`slowtv_monodepth_tpu_torch.databases` was missing once). Every directory of
the port that holds an `__init__.py` must be listed, and every console script
of the port must name a module that exists and a function in it.
"""
import ast
import tomllib
from pathlib import Path

import pytest
from torch_threads import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'slowtv_monodepth_tpu_torch'


@pytest.fixture(scope='module')
def project():
    with open(ROOT / 'pyproject.toml', 'rb') as f:
        return tomllib.load(f)


def test_every_port_package_is_listed(project):
    listed = set(project['tool']['setuptools']['packages'])
    found = {'.'.join(p.parent.relative_to(ROOT).parts) for p in PORT.rglob('__init__.py')}
    assert {'slowtv_monodepth_tpu_torch.databases', 'slowtv_monodepth_tpu_torch.eval'} <= found
    assert found - listed == set()


def test_every_port_console_script_resolves(project):
    scripts = {k: v for k, v in project['project']['scripts'].items() if k.endswith('-torch')}
    assert {'slowtv-export-gt-torch', 'slowtv-export-gt-kitti-torch', 'slowtv-export-preds-torch',
            'slowtv-eval-depth-torch', 'slowtv-tables-torch', 'slowtv-validate-release-torch',
            'slowtv-mapfree-preds-torch'} <= set(scripts)
    for name, target in scripts.items():
        module, func = target.split(':')
        file = ROOT / (module.replace('.', '/') + '.py')
        assert file.is_file(), name
        funcs = {n.name for n in ast.parse(file.read_text()).body if isinstance(n, ast.FunctionDef)}
        assert func in funcs, name
