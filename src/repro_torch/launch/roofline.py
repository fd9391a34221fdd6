"""Roofline terms of the port's programs on an NVIDIA H100 (the JAX
package's ``repro/launch/roofline.py``).

Per (arch × shape × mesh), from one rank's counts (``launch/dryrun.py``,
``serving/profiling.py:measure``):

    compute    = FLOPs_per_rank  / (989 TFLOP/s, bf16 tensor cores, dense)
    memory     = HBM_bytes_per_rank / (3.35 TB/s)
    collective = collective_bytes_per_rank / (450 GB/s NVLink each way)

The constants are ``core/profiler.py``'s H100 SXM data-sheet rates, in
place of the JAX package's TPU v5e ones.

The counts come from running the port's eager program on the meta device
(operator by operator, plus each hand-written kernel's
``kernels/costs.py`` cost): they already hold every trip of every layer.
XLA's cost analysis counts a scanned layer's body once, so the JAX package
lowers one block on its own and adds ``(trips - 1) x body`` to the whole
program; that correction must never be applied to these counts.
:func:`block_cost` is here to break a program down by block, as
``lower_block_cost`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core.offload import tree_leaves, tree_map
from repro_torch.core.profiler import (H100_HBM_BW, H100_NVLINK_BW,
                                       H100_PEAK_FLOPS_BF16)
from repro_torch.launch.mesh import shard_params
from repro_torch.models import model as M
from repro_torch.models import sharding
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.serving.profiling import measure

META = torch.device("meta")

MODE_TRIPS = {  # layers a program runs its block over
    "train": lambda cfg: cfg.num_layers,
    "prefill": lambda cfg: cfg.num_layers,
    "decode": lambda cfg: cfg.num_layers,
}


def _block_kind(cfg) -> str:
    # the audio decoder's block approximated as dense (its S x F
    # cross-attention is small next to S x S self-attention); the hybrid's
    # block is the Mamba layer, its shared attention block measured apart
    return {"ssm": "ssm", "hybrid": "ssm", "audio": "dense"}.get(
        cfg.family, "moe" if cfg.num_experts else "dense")


def block_cost(cfg: ModelConfig, shape: InputShape, mesh,
               kind: Optional[str] = None) -> Dict[str, float]:
    """One rank's cost of ONE block at this shape on ``mesh`` (None: one
    device), run on the meta device with the serving cut of its params
    (JAX's ``fsdp=False``): the forward, and for ``train`` the forward and
    backward (gradients of the params) plus one more forward (remat's
    recompute).  {"flops", "bytes", "coll"} with the kernels' costs in."""
    kind = kind or _block_kind(cfg)
    dtype = cfg.torch_dtype
    decode = shape.mode == "decode"
    B = shape.global_batch
    S = 1 if decode else shape.seq_len     # the vlm's rows: frontend + text
    gen = torch.Generator()
    stack = {"blocks": tfm.init_stack(gen, cfg, dtype, META, kind, 1)}
    if mesh is not None:
        stack = shard_params(stack, mesh)
    p = tfm.layer_slice(stack["blocks"], 0)
    shard = None
    if mesh is not None:
        shard = sharding.rank_shard(mesh, B, Hkv=cfg.num_kv_heads,
                                    S=shape.seq_len) if decode \
            else sharding.rank_shard(mesh, B)
    B_loc = shard.B_loc if shard is not None else B
    x = torch.empty((B_loc, S, cfg.d_model), dtype=dtype, device=META)
    cache = index = None
    if decode:
        index = torch.zeros((), dtype=torch.int32, device=META)
        positions = index.reshape(1)
        if kind == "ssm":
            m = mesh.shape.get("model", 1) if mesh is not None else 1
            conv, ssm = ssm_mod.mamba_state_shapes(cfg, B_loc, m)
            cache = (torch.empty(conv, dtype=dtype, device=META),
                     torch.empty(ssm, dtype=torch.float32, device=META))
        else:
            hkv = p["attn"]["wk"].shape[-2]
            rows = shard.S_loc if shard is not None else shape.seq_len
            kv = torch.empty((B_loc, rows, hkv, cfg.head_dim), dtype=dtype,
                             device=META)
            cache = {"self": {"k": kv, "v": torch.empty_like(kv)}}
    else:
        positions = torch.arange(S, device=META)

    def fwd(params):
        y, _, _ = tfm.block_apply(
            params, x, cfg, kind=kind, mode="decode" if decode else "train",
            positions=positions, cache=cache, cache_index=index,
            use_kernels=True, shard=shard)
        return y

    def run(fn) -> Dict[str, float]:
        with sharding.activation_sharding(mesh):
            rec = measure(fn, mesh)
        return {"flops": rec["flops"], "bytes": rec["bytes_accessed"],
                "coll": rec["collective_bytes"]["total"]}

    if shape.mode != "train":
        with torch.no_grad():
            return run(lambda: fwd(p))
    cost_f = run(lambda: fwd(p))

    def grads():
        leaves = tree_map(lambda t: t.detach().requires_grad_(
            t.is_floating_point()), p)
        flat = [t for t in tree_leaves(leaves) if t.requires_grad]
        return torch.autograd.grad(fwd(leaves).float().sum(), flat,
                                   allow_unused=True)

    cost_g = run(grads)
    # remat adds one forward recompute on top of forward + backward
    return {k: cost_g[k] + cost_f[k] for k in cost_f}


# ---------------------------------------------------------------------------
@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mode: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_per_chip: float
    model_flops: float           # 6·N(_active)·tokens, global

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / H100_PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / H100_HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_per_chip / H100_NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else float("nan")

    def row(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mode": self.mode,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode processes B tokens;
    train counts fwd+bwd (6·), inference counts 2·N·D."""
    n = M.count_params_analytic(cfg, active_only=bool(cfg.num_experts))
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # one token per sequence


def terms(res: Dict[str, Any]) -> RooflineTerms:
    """The roofline terms of one dry-run result (``dryrun.run_dryrun``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import get_shape
    cfg, shape = get_config(res["arch"]), get_shape(res["shape"])
    chips = 1
    for n in res["mesh"].values():
        chips *= n
    return RooflineTerms(res["arch"], res["shape"], res["mode"], chips,
                         res["flops"], res["bytes_accessed"],
                         res["collective_bytes"]["total"],
                         model_flops(cfg, shape))
