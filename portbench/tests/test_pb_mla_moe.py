"""The mla_moe family (moonlight-16b-a3b): its weights in the port's
layout, its reference against a per-token loop, its operation and cost
formulas against hand counts, and the check of the longdoc cell at a
small size on the CPU: a sound run reads correct, the fp8 control and four
planted faults read not correct (the routing bias dropped, the shared
experts dropped, the latent RMSNorm skipped, the 2.446 routed scaling
omitted)."""
import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.families import common, mla_moe

import pb_small

PB = Path(__file__).resolve().parent.parent
CELL = "moonlight-16b-a3b.longdoc"
SMALL = dict(num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, intermediate_size=96, moe_intermediate_size=24,
             n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=2,
             vocab_size=512, dtype="float32")
MIX = dict(pb_small.MIX, prompt_len=96)


def port_config(config):
    """The port's MLAConfig of a configuration file's numbers (the
    harness's ``port_config`` replaces ModelConfig's own fields only; the
    file names the published config.json's keys)."""
    from repro_torch.configs.base import get_config
    c = config
    return dataclasses.replace(
        get_config(c["arch"]), num_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"],
        head_dim=c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
        d_ff=c["moe_intermediate_size"], vocab_size=c["vocab_size"],
        num_experts=c["n_routed_experts"],
        experts_per_token=c["num_experts_per_tok"],
        num_shared_experts=c["n_shared_experts"],
        rope_theta=float(c["rope_theta"]), kv_lora_rank=c["kv_lora_rank"],
        qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        first_k_dense=c["first_k_dense_replace"],
        dense_d_ff=c["intermediate_size"],
        routed_scaling=c["routed_scaling_factor"],
        tie_embeddings=c["tie_word_embeddings"], dtype=c["dtype"])


def _file():
    return json.loads((PB / "configs" / "moonlight-16b-a3b.json").read_text())


def _small(**kw):
    c = {**_file(), **SMALL, **kw}
    c["num_key_value_heads"] = c["num_attention_heads"]
    return c


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), tree.dtype)}


def test_registered_config_is_the_file_as_published():
    """Every number the port serves is the file's (the published
    config.json's), nothing reduced."""
    from repro_torch.configs.base import get_config
    c = _file()
    assert c["reduced"] == [] and c["family"] == "mla_moe"
    assert port_config(c) == get_config(c["arch"])
    assert (c["num_hidden_layers"], c["hidden_size"], c["n_routed_experts"],
            c["vocab_size"]) == (27, 2048, 64, 163840)


def test_make_params_is_the_port_layout():
    from repro_torch.models import model as M
    c = _small()
    ref = mla_moe.make_params(common.sizes(c), 5, "cpu")
    port = M.init_params(port_config(c), 5, device="cpu")
    assert _leaves(ref) == _leaves(port)


def _naive_logits(params, cfg, seq):
    """The model token by token: each position's attention over the keys
    at or before it, head by head, and its MoE layer expert by expert of
    its own choice; plain float32."""
    H, r = cfg.num_attention_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    eps = cfg.rms_norm_eps

    def rms(x, s, e):
        return x / torch.sqrt((x * x).mean() + e) * s

    def rope(x, pos):                      # x [.., dr]: halves rotated
        half = x.shape[-1] // 2
        out = torch.empty_like(x)
        for i in range(half):
            a = pos / cfg.rope_theta ** (2 * i / x.shape[-1])
            c, s = math.cos(a), math.sin(a)
            out[..., i] = x[..., i] * c - x[..., i + half] * s
            out[..., i + half] = x[..., i + half] * c + x[..., i] * s
        return out

    def swiglu(h, p):
        g = h @ p["w_gate"].float()
        return (g / (1 + torch.exp(-g)) * (h @ p["w_up"].float())) \
            @ p["w_down"].float()

    T = len(seq)
    xs = [params["embed"]["table"][int(t)].float() for t in seq]
    for name in ("dense", "moe"):
        st = params["blocks"][name]
        for li in range(st["ln1"]["scale"].shape[0]):
            p = common.layer(st, li)
            a = p["attn"]
            ks, vs, qs = [], [], []
            for t in range(T):
                h = rms(xs[t], p["ln1"]["scale"], eps)
                q = (h @ a["wq"].reshape(h.shape[0], -1)).view(H, dn + dr)
                kv = h @ a["wkv_a"]
                c = rms(kv[:r], a["kv_norm"]["scale"], 1e-6)
                kb = (c @ a["wkv_b"].reshape(r, -1)).view(H, dn + dv)
                kpe = rope(kv[r:], t)
                qs.append(torch.cat([q[:, :dn], rope(q[:, dn:], t)], -1))
                ks.append(torch.cat([kb[:, :dn], kpe.expand(H, dr)], -1))
                vs.append(kb[:, dn:])
            new = []
            for t in range(T):
                o = torch.empty(H, dv)
                for hd in range(H):
                    s = torch.stack([qs[t][hd] @ ks[j][hd] for j in range(t + 1)])
                    w = torch.softmax(s / math.sqrt(dn + dr), 0)
                    o[hd] = sum(w[j] * vs[j][hd] for j in range(t + 1))
                x = xs[t] + o.reshape(-1) @ a["wo"].reshape(H * dv, -1)
                h = rms(x, p["ln2"]["scale"], eps)
                if name == "dense":
                    x = x + swiglu(h, p["mlp"])
                else:
                    m = p["moe"]
                    sc = torch.sigmoid(h @ m["router"])
                    pick = torch.topk(sc + m["router_bias"],
                                      cfg.num_experts_per_tok).indices
                    w = sc[pick] / sc[pick].sum() * cfg.routed_scaling_factor
                    y = swiglu(h, m["shared"])
                    for wi, e in zip(w, pick.tolist()):
                        y = y + wi * swiglu(h, {n: m[n][e] for n in
                                                ("w_gate", "w_up", "w_down")})
                    x = x + y
                new.append(x)
            xs = new
    fn = params["final_norm"]["scale"]
    table = params["lm_head"]["table"].float()
    return torch.stack([rms(x, fn, eps) @ table.T for x in xs])


def test_reference_matches_a_per_token_loop():
    c = _small(num_hidden_layers=2, hidden_size=32, num_attention_heads=2,
               kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
               v_head_dim=8, intermediate_size=48, moe_intermediate_size=12,
               n_routed_experts=6, num_experts_per_tok=2, vocab_size=64)
    sizes = common.sizes(c)
    params = mla_moe.make_params(sizes, 11, "cpu")
    seq = torch.randint(0, 64, (9,), generator=torch.Generator().manual_seed(2))
    got = mla_moe.logits(params, sizes, [seq], [torch.arange(9)])[0]
    want = _naive_logits(params, sizes, seq)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_request_flops_by_hand():
    """moonlight at its published sizes: 2 x 2,243,559,424 operations a
    token in the layers (the dense layer 82,968,576 weights, each MoE layer
    13,762,560 attention + 131,072 router + 8 x 8,650,752 expert weights),
    2 x 16 x 320 a key attended, 2 x 163,840 x 2,048 the head."""
    s = common.sizes(_file())
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    assert attn == 13_762_560
    per_token = 2 * ((attn + 3 * 2048 * 11264)
                     + 26 * (attn + 2048 * 64 + 8 * 3 * 2048 * 1408))
    assert per_token == 2 * 2_243_559_424
    P, n = 7168, 24
    keys = 23 * P + 23 * 24 // 2
    want = (P * per_token + 27 * 2 * 16 * 320 * P * (P + 1) // 2
            + 2 * 163840 * 2048
            + 23 * per_token + 27 * 2 * 16 * 320 * keys + 23 * 2 * 163840 * 2048)
    assert mla_moe.request_flops(s, P, n) == float(want)


def test_cost_formulas_by_hand():
    assert mla_moe.mla_decode_cost(2, 16, 576, 512, 100, 2) == {
        "flops": 2 * 16 * 100 * 1088,
        "bytes": 100 * 1152 + 2 * 16 * 1088 * 2 + 8}
    pairs = 7168 * 7169 // 2
    assert mla_moe.prefill_attention_cost(7168, 16, 192, 128, 2) == {
        "flops": 2 * 16 * 320 * pairs, "bytes": 2 * 2 * 7168 * 16 * 320}


def _run(monkeypatch, **kw):
    monkeypatch.setattr(harness, "port_config", port_config)
    torch.manual_seed(0)
    return harness.run_cell(PB.parent, CELL, 31000000007, 0.3, False,
                            device="cpu", look_for_chip=False,
                            mix_override=MIX, config_override=SMALL,
                            limits_override=pb_small.LIMITS, **kw)


def _bias_dropped(monkeypatch):
    from repro_torch.models import moe
    route = moe.route_biased
    monkeypatch.setattr(moe, "route_biased", lambda xt, r, b, cfg: route(
        xt, r, torch.zeros_like(b), cfg))


def _shared_dropped(monkeypatch):
    from repro_torch.models import moe
    monkeypatch.setattr(moe, "mlp_apply", lambda p, x, cfg: torch.zeros_like(x))


def _latent_norm_skipped(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "norm_apply",
                        lambda p, x, cfg, eps=1e-5: x)


def _scaling_omitted(monkeypatch):
    from repro_torch.models import moe
    route = moe.route_biased

    def unscaled(xt, r, b, cfg):
        w, ids = route(xt, r, b, cfg)
        return w / cfg.routed_scaling, ids
    monkeypatch.setattr(moe, "route_biased", unscaled)


FAULTS = {"bias_dropped": _bias_dropped, "shared_dropped": _shared_dropped,
          "latent_norm_skipped": _latent_norm_skipped,
          "scaling_omitted": _scaling_omitted}


def test_sound_run_is_correct(monkeypatch):
    res = _run(monkeypatch)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0


def test_control_is_not_correct(monkeypatch):
    res = _run(monkeypatch, control=True)
    assert not res["correct"], res["compared"]
    assert res["served_logit_gap"] <= pb_small.LIMITS["logit_gap"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_caught(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = _run(monkeypatch)
    assert not res["correct"], res["compared"]
