"""The port's tests remove the files they write once they pass.

A whole run of the suite writes gigabytes of checkpoints, datasets and
predictions under pytest's base temporary directory, and pytest keeps the
directories of the last three runs (of a run that was killed, for three days).
So a test module of the port that writes files imports `drop_tmp_path`: a test
that passed has its `tmp_path` removed as it ends, one that failed keeps it to
be read. A module fixture that writes under `tmp_path_factory` removes its
directory the same way with `drop_if_passed`.
"""
import shutil
from pathlib import Path

import pytest

__all__ = ['drop_tmp_path', 'drop_if_passed']


def drop_if_passed(request, failed_before: int, path: Path) -> None:
    """Remove `path` unless a test failed since the session counted `failed_before`."""
    if request.session.testsfailed == failed_before:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(autouse=True)
def drop_tmp_path(request):
    failed = request.session.testsfailed
    yield
    path = request.node.funcargs.get('tmp_path')
    if path is not None:
        drop_if_passed(request, failed, path)
