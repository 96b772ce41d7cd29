"""A run imports neither JAX nor the JAX package; the reference imports
nothing of the program either."""
import ast
import json
import subprocess
import sys

import pytest

from conftest import ROOT, SMALL

BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _top(names):
    return {n.split(".")[0] for n in names}


def test_no_file_of_the_benchmark_imports_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _top(_imports(path)) & BANNED, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert not _top(_imports(path)) & (BANNED | {"repro_torch"}), path
    code = ("import importlib.util, sys\n"
            f"for p in {sorted(str(p) for p in (ROOT / 'portbench' / 'reference').glob('*.py'))!r}:\n"
            "    s = importlib.util.spec_from_file_location('r', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    held = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not held & (BANNED | {"repro_torch", "portbench"})


@pytest.mark.parametrize("cell", ["cusz-nyx.compress",
                                  "cusz-hacc.decompress"])
def test_a_run_holds_no_jax(cell):
    """A whole run (traced, so the profiler is in too) in a process of
    its own: the top-level modules it holds at the end."""
    config = SMALL[cell.split(".")[0]]
    code = ("import json, sys\n"
            f"sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "from portbench import harness\n"
            f"r = harness.run({cell!r}, 3, 0.2, True, device='cpu', "
            f"config={config!r}, emit=lambda d: None)\n"
            "print(json.dumps([r['correct'], sorted({m.split('.')[0] "
            "for m in sys.modules})]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    correct, held = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and "repro_torch" in held
    assert not set(held) & BANNED


def test_the_harness_refuses_a_run_that_holds_jax(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(harness.Refused):
        harness.run("cusz-nyx.compress", 1, 0.05, False, device="cpu",
                    config=SMALL["cusz-nyx"], emit=lambda d: None)
