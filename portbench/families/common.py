"""What the families' weights and references share: seeded draws on the
device, one layer upcast to float32 at a time, the float32 / fp8 matrix
product, and the LM head at chosen positions.  Plain PyTorch only."""
from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Callable, Dict, List

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sizes(config: Dict) -> SimpleNamespace:
    """The configuration file's numbers as attributes, with the served
    dtype as ``torch_dtype``."""
    ns = SimpleNamespace(**{k: v for k, v in config.items()
                            if not isinstance(v, (list, dict))})
    ns.torch_dtype = _DTYPES[config["dtype"]]
    return ns


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) % 2**63)
    return g


class Draw:
    """Seeded draws straight into the served dtype, one call a leaf."""

    def __init__(self, gen: torch.Generator, device, dtype):
        self.gen, self.device, self.dtype = gen, torch.device(device), dtype

    def normal(self, shape, scale: float, dtype=None) -> torch.Tensor:
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=dtype or self.dtype)
        return t.mul_(scale)

    def norm(self, shape, norm_type: str) -> Dict[str, torch.Tensor]:
        """Float32 norm weights near 1 (and a bias near 0 for LayerNorm),
        so that a path that drops them shows."""
        out = {"scale": self.normal(shape, 0.1, torch.float32).add_(1.0)}
        if norm_type == "layernorm":
            out["bias"] = self.normal(shape, 0.1, torch.float32)
        return out


def layer(tree, i: int):
    """Layer ``i`` of an L-stacked tree, upcast to float32."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i].float()


@contextlib.contextmanager
def plain_float32():
    """Float32 products without TF32, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 with one scale for the tensor (its
    absolute maximum at 448), back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def matmul(control: bool) -> Callable:
    """``mm(x, w)``: x @ w in float32; under ``control`` both rounded to
    fp8 first."""
    if not control:
        return lambda x, w: x @ w
    return lambda x, w: fp8(x) @ fp8(w)


def head(xs: List[torch.Tensor], want: List[torch.Tensor], table,
         norm: Callable, mm: Callable) -> List[torch.Tensor]:
    """The LM head's float32 logits of each sequence at its positions."""
    t = table.float().T
    return [mm(norm(x[w]), t) for x, w in zip(xs, want)]
