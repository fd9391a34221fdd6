"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py)
imports jax or the JAX package, by source scan and at run time."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_no_jax_or_repro_imports_in_source():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PKG.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    assert {"repro_torch.models.ssm", "repro_torch.kernels.ssm_scan",
            "repro_torch.configs.falcon_mamba_7b",
            "repro_torch.configs.zamba2_2_7b"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_cpu_fallback():
    """Without device= the entry points run on the card; with no card they
    raise instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only refusal")
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    cfg = reduced(get_config("llama3.2-1b"), d_model=64, vocab=32)
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(cfg, 0)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "2"])


def test_cpu_tensors_never_count_as_launches():
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    q = torch.randn(2, 1, 4, 64)
    kv = torch.randn(2, 16, 2, 64)
    ops.decode_attention(q, kv, kv, torch.tensor([3, 16]))
    ops.masked_compact(torch.randn(2, 16, 8), torch.rand(2, 16) < 0.5, 8)
    w = torch.randn(2, 8, 16)
    ops.grouped_ffn(torch.randn(2, 4, 8), w, w, torch.randn(2, 16, 8))
    ops.ssm_scan(torch.rand(1, 4, 8, 2), torch.randn(1, 4, 8, 2), torch.randn(1, 8, 2))
    assert ops.launch_counts() == {"decode_attention": 0, "masked_compact": 0,
                                   "grouped_ffn": 0, "ssm_scan": 0}
