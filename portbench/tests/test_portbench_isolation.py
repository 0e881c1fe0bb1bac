"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's), and
the plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

from portbench import harness

PROGRAM = "mocov2_whisper_flamingo_torch"


def _imports(path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax():
    files = sorted(harness.PACKAGE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        found = _imports(path) & set(harness.FORBIDDEN_MODULES)
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((harness.PACKAGE / "reference").glob("*.py"))
    assert files
    for path in files:
        assert PROGRAM not in _imports(path), path
        assert _imports(path) <= {"__future__", "contextlib", "functools", "math", "statistics",
                                  "torch", "portbench"}, path


def test_whole_names_are_compared():
    sys.modules.setdefault("mocov2_whisper_flamingo_tpu_lookalike_probe", sys)
    try:
        assert "mocov2_whisper_flamingo_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["mocov2_whisper_flamingo_tpu_lookalike_probe"]


def test_a_cell_process_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh interpreter, then the harness's own look
    at ``sys.modules``."""
    code = textwrap.dedent(f"""
        import json, pathlib, sys
        from portbench import harness
        from portbench.tests import tiny
        bench, root = tiny.make_root(pathlib.Path({str(tmp_path)!r}))
        result, _ = tiny.run(bench, root, "tiny.train", seconds=0.3)
        print(json.dumps({{"forbidden": harness.forbidden_modules(),
                          "program": "{PROGRAM}" in sys.modules}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.PACKAGE.parent, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    last = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert last == {"forbidden": [], "program": True}
