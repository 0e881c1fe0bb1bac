"""``ops/kernels.py`` without a compiler: first use of a kernel from several
threads at once (a caller of ``build_all`` beside serving threads in ``load``)
compiles every source once, never two ``nvcc`` into one output at a time."""

import threading
import time

import pytest

from mocov2_whisper_flamingo_torch.ops import kernels
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

WAIT = 60


class _FakeNvcc:
    """Stands in for ``subprocess.Popen(nvcc ...)``: takes a while, writes
    its ``-o`` file, and notes how many of its kind ran at once per output."""

    lock = threading.Lock()
    running: dict[str, int] = {}
    started: list[str] = []
    overlaps: list[str] = []

    def __init__(self, cmd, **_):
        self.out = cmd[cmd.index("-o") + 1]
        self.returncode = None
        cls = type(self)
        with cls.lock:
            cls.started.append(self.out)
            cls.running[self.out] = cls.running.get(self.out, 0) + 1
            if cls.running[self.out] > 1:
                cls.overlaps.append(self.out)

    def communicate(self):
        time.sleep(0.2)
        with open(self.out, "w") as f:
            f.write("not a library")
        with type(self).lock:
            type(self).running[self.out] -= 1
        self.returncode = 0
        return "ptxas info: fake", None


@pytest.fixture()
def fake_build(tmp_path, monkeypatch):
    _FakeNvcc.running, _FakeNvcc.started, _FakeNvcc.overlaps = {}, [], []
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(kernels, "_libs", {})
    loaded = []
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: loaded.append(path) or object())
    return loaded


def test_first_use_from_several_threads_compiles_once(fake_build):
    results, errors = [], []

    def worker(fn):
        try:
            results.append(fn())
        except Exception as e:  # collected and asserted empty below
            errors.append(e)

    calls = [kernels.build_all] + [lambda: kernels.load("flash_attention")] * 5
    threads = [threading.Thread(target=worker, args=(fn,)) for fn in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    n_sources = len(list(kernels.CSRC.glob("*.cu")))
    assert len(_FakeNvcc.started) == n_sources >= 1  # one nvcc per source, in all
    assert not _FakeNvcc.overlaps
    assert len(fake_build) == 1  # the library was opened once and shared
    libs = [r for r in results if not isinstance(r, dict)]
    assert len(libs) == 5 and all(lib is libs[0] for lib in libs)
    built = kernels.build_all()
    assert all(path.exists() for path in built.values())
    assert len(_FakeNvcc.started) == n_sources  # nothing is rebuilt
    assert not list(kernels.BUILD_DIR.glob("*.tmp"))


def test_failed_build_raises_with_the_compiler_output(fake_build, monkeypatch):
    class Failing(_FakeNvcc):
        def communicate(self):
            self.returncode = 1
            return "error: identifier undefined", None

    monkeypatch.setattr(kernels.subprocess, "Popen", Failing)
    with pytest.raises(RuntimeError, match="identifier undefined"):
        kernels.load("flash_attention")
    assert not fake_build  # nothing was opened, and nothing stands in for the kernel
