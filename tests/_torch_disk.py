"""What the port's tests write into pytest's basetemp, and its removal.

Pytest keeps every test's `tmp_path` and every `tmp_path_factory.mktemp`
directory after the run, and the basetemps of the last three runs.  The
port's training tests write checkpoints of hundreds of MB there (the
expert-parallel CLI test 1.5 GB), which left gigabytes behind each run.
Every `tests/test_torch_*.py` file imports the two autouse fixtures below:

    from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

* `remove_tmp_path` removes a test's `tmp_path` once the test has passed
  (a failed test's stays, for its post-mortem);
* `remove_module_tmp` removes, when the module ends, every directory the
  module made in this process's basetemp (its `mktemp` fixtures'), unless
  one of its tests failed.

With xdist each worker has its own basetemp and runs one module at a time,
so a module removes only its own directories.  `bytes_left` measures what
a test's `tmp_path` left, for the pins that hold the largest writers under
`LIMIT_BYTES`; a pin needs the test it measures to have run before it in
the same process, as the file's order gives under `--dist loadfile`.
"""

from __future__ import annotations

import os
import re
import shutil

import pytest

LIMIT_BYTES = 20 * 2**20  # what a test may leave in its tmp_path
_RAN = set()  # node ids of the tests with a tmp_path that ran in this process


def tree_bytes(path: str) -> int:
    """The bytes of the files under `path`, a hard-linked file once (0 when
    it does not exist)."""
    seen = {}
    for dirpath, _, names in os.walk(path):
        for name in names:
            try:
                st = os.lstat(os.path.join(dirpath, name))
            except FileNotFoundError:
                continue
            seen[(st.st_dev, st.st_ino)] = st.st_size
    return sum(seen.values())


def tmp_path_prefix(test_name: str) -> str:
    """The name pytest gives a test's `tmp_path` directory, before its
    number (`_pytest/tmpdir.py::_mk_tmp`)."""
    return re.sub(r"[\W]", "_", test_name)[:30]


def bytes_left(request, test_function: str) -> int:
    """What the tests of `test_function` (every parametrization) that ran in
    this process left in their `tmp_path` directories of the basetemp.
    Skips when none of them ran here (deselected, or run by another xdist
    worker under `--dist load`): there is nothing of theirs to measure."""
    if not callable(getattr(request.module, test_function, None)):
        raise LookupError(f"{request.module.__name__} has no test {test_function}")
    base = str(request.getfixturevalue("tmp_path_factory").getbasetemp())
    prefixes = {tmp_path_prefix(item.name) for item in request.session.items
                if item.originalname == test_function and item.nodeid in _RAN}
    if not prefixes:
        pytest.skip(f"{test_function} did not run in this process")
    return sum(tree_bytes(os.path.join(base, name)) for name in os.listdir(base)
               if any(name.startswith(p) and name[len(p):].isdigit() for p in prefixes))


@pytest.fixture(autouse=True)
def remove_tmp_path(request):
    failed = request.session.testsfailed
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        _RAN.add(request.node.nodeid)
    if path is not None and request.session.testsfailed == failed:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def remove_module_tmp(request, tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    before, failed = set(os.listdir(base)), request.session.testsfailed
    yield
    if request.session.testsfailed != failed:
        return
    for name in set(os.listdir(base)) - before:
        shutil.rmtree(os.path.join(base, name), ignore_errors=True)
