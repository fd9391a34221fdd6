"""The plain reference against the port at reduced() float32 sizes on the
CPU: the port's prefill logits and three decode steps through its cache
against the reference's full forward pass, the weights from the
benchmark's own draw; and the fp8 control reading further from the
reference than the port does."""
import dataclasses

import pytest
import torch

from portbench.families import common, dense_gqa

FAMILIES = {"nemotron-4-15b": dense_gqa}
KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
        "d_ff", "vocab_size", "norm_type", "mlp_type", "rope_theta",
        "tie_embeddings")


def _setup(arch):
    from repro_torch.configs.base import get_config, reduced
    cfg = reduced(get_config(arch))
    config = {k: getattr(cfg, k) for k in KEYS}
    config["dtype"] = "float32"
    return cfg, common.sizes(config)


def _port_logits(cfg, params, seq, P):
    """Prefill of seq[:P], then the later tokens through the decode cache:
    the logits at positions P-1 .. len(seq)-1."""
    from repro_torch.models import model as M
    out = M.forward(params, cfg, {"tokens": seq[None, :P]}, mode="prefill")
    logits = [out.logits[0, -1]]
    cache = M.init_cache(cfg, 1, len(seq) + 1, device="cpu")
    from repro_torch.serving.engine import seed_cache
    cache = seed_cache(cfg, cache, out.cache, P)
    for pos in range(P, len(seq)):
        o = M.forward(params, cfg, {"token": seq[None, pos:pos + 1],
                                    "cache": cache, "cache_index": pos},
                      mode="decode")
        logits.append(o.logits[0, 0])
    return torch.stack(logits)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_reference_matches_port(arch):
    cfg, sizes = _setup(arch)
    fam = FAMILIES[arch]
    params = fam.make_params(sizes, 20260101, "cpu")
    g = torch.Generator().manual_seed(3)
    P, seq = 256, torch.randint(0, sizes.vocab_size, (259,), generator=g)
    with torch.no_grad():
        port = _port_logits(cfg, params, seq, P)
    ref = fam.logits(params, sizes, [seq], [torch.arange(P - 1, len(seq))])[0]
    scale = ref.abs().max()
    assert float((port - ref).abs().max()) <= 1e-4 * float(scale)
    # the control: fp8 products move the logits by far more
    ctl = fam.logits(params, sizes, [seq], [torch.arange(P - 1, len(seq))],
                     control=True)[0]
    assert float((ctl - ref).abs().max()) > 100 * float((port - ref).abs().max())


def test_reference_sees_gqa_groups():
    """Query heads of one kv group share its K/V: a reference that paired
    query head h with kv head h % Hkv would differ."""
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config("nemotron-4-15b"), num_layers=1,
                              d_model=96, num_heads=6, num_kv_heads=2,
                              head_dim=16, d_ff=64, vocab_size=64,
                              dtype="float32")
    config = {k: getattr(cfg, k) for k in KEYS}
    config["dtype"] = "float32"
    sizes = common.sizes(config)
    params = dense_gqa.make_params(sizes, 5, "cpu")
    seq = torch.randint(0, 64, (40,), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        port = _port_logits(cfg, params, seq, 32)
    ref = dense_gqa.logits(params, sizes, [seq], [torch.arange(31, 40)])[0]
    assert float((port - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
