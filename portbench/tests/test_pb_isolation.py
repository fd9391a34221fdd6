"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the port.  Names are compared by their
top-level part, before the first dot, whole: ``repro_torch`` is the port,
``repro`` the JAX package."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE = [PB / "yardstick.py", *sorted((PB / "families").glob("*.py"))]


def _top_levels(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_top_levels(path)) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(_top_levels(path))
    assert not names & (FORBIDDEN | {"repro_torch"})
    assert names <= {"__future__", "math", "contextlib", "types", "typing",
                     "torch", "numpy", "portbench"}


def test_top_level_names_compared_whole():
    assert "repro_torch.models".split(".")[0] not in FORBIDDEN
    assert "repro.models".split(".")[0] in FORBIDDEN


def test_no_jax_in_sys_modules_after_a_run(root):
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(PB / 'tests')!r}, {root!r}, "
        f"{os.path.join(root, 'src')!r}]\n"
        "import pb_small\n"
        f"res = pb_small.run({root!r}, 'nemotron-4-15b.docqa')\n"
        "found = sorted({m.split('.')[0] for m in sys.modules} & "
        f"set({sorted(FORBIDDEN)!r}))\n"
        "print(json.dumps({'correct': res['correct'], 'found': found}))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"correct": True, "found": []}
