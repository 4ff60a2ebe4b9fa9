"""The kernel loader across threads (``repro_torch.kernels._build``).

Replica pump threads of the async front end can launch their first kernel
at the same moment.  Against a fake compiler (a script given as ``nvcc``
that writes its ``-o`` file after a pause) and a fake ``ctypes.CDLL``,
two threads that build and load the same kernel together must compile it
once, leave one library and no temporary file, and both get the one
loaded library.
"""
import os
import sys
import threading
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
time.sleep(0.3)
with open(args[args.index("-o") + 1], "wb") as f:
    f.write(b"not a real library")
"""


class _FakeLib:
    """What ``load`` types: the entry point and the error-string call."""
    opened = []

    def __init__(self, path):
        _FakeLib.opened.append(path)
        for entry, _ in _build.ENTRY_POINTS.values():
            setattr(self, entry, SimpleNamespace())
        self.repro_cuda_error_string = SimpleNamespace()


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLib)
    _FakeLib.opened = []
    return log


@pytest.mark.parametrize("first_call", ["build_all", "load"])
def test_two_threads_build_and_load_one_library(fake_toolchain, first_call):
    name = "paged_prefill"
    start = threading.Barrier(2)
    got, errors = [None, None], []

    def worker(i):
        try:
            start.wait(timeout=10)
            if first_call == "build_all":
                _build.build_all([name])
            got[i] = _build.load(name)
        except Exception as e:  # reported by the main thread below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(fake_toolchain.read_text().splitlines()) == 1  # one nvcc
    built = sorted(os.listdir(_build.BUILD_DIR))
    lib = _build.library_path(name)
    assert built == sorted([lib.name, lib.with_suffix(".log").name])
    assert _FakeLib.opened == [str(lib)]
    assert got[0] is got[1] is _build._loaded[name]
