"""Moonlight-16B-A3B's mechanisms in the port on the CPU, against the
benchmark's plain float32 reference (``portbench/families/mla_moe.py``): a
small MLAConfig that keeps the leading dense layer, two MoE layers and
fewer experts a token than experts, with the reference's own weight draw.

Prefill and decode through the model and through the continuous engine,
the absorbed decode against the expanded attention, the dropless router
(a bias that forces every token onto one expert; a bias that changes the
choices and not the weights), the MLA decode kernel's route, plain version
and cost, the prefill kernel's q/k 192, v 128 instance's plan, what MLA
refuses, the parameter count and the gradient of the plain path.

Tolerances: the port and the reference both compute in float32 here, in
other orders of summation (chunked online softmax against one softmax,
the absorbed decode against the expanded one, the experts over a sorted
buffer against a loop per expert), so logits agree to 1e-4 of the largest
logit, and an attention or MoE output to 1e-5 of its largest value."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench.families import common, mla_moe  # noqa: E402
from repro_torch.configs.base import (MLAConfig, get_config, is_mla,  # noqa: E402
                                     list_configs, reduced)
from repro_torch.core.offload import tree_leaves  # noqa: E402
from repro_torch.kernels import costs, ops, ref  # noqa: E402
from repro_torch.kernels import mla_decode_attention as mk  # noqa: E402
from repro_torch.kernels import prefill_attention as pa  # noqa: E402
from repro_torch.models import attention, moe, sharding  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import (ContinuousServingEngine,  # noqa: E402
                                        ServeRequest, seed_cache)

ARCH = "moonlight-16b-a3b"
# the reference's configuration keys (the published config.json's names)
SMALL = dict(num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, intermediate_size=96, moe_intermediate_size=24,
             n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=2,
             first_k_dense_replace=1, routed_scaling_factor=2.446,
             rms_norm_eps=1e-5, rope_theta=50000, vocab_size=512,
             tie_word_embeddings=False, dtype="float32")
LOGIT_TOL = 1e-4
OUT_TOL = 1e-5


def port_config(c) -> MLAConfig:
    """The port's configuration of a reference configuration ``c``."""
    return dataclasses.replace(
        get_config(ARCH), num_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_attention_heads"],
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
        routed_scaling=c["routed_scaling_factor"], dtype=c["dtype"])


@pytest.fixture(scope="module")
def small():
    sizes = common.sizes(SMALL)
    return port_config(SMALL), sizes, mla_moe.make_params(sizes, 20261018,
                                                         "cpu")


def _port_logits(cfg, params, seq, P):
    """Prefill of seq[:P], then the later tokens through the decode cache:
    the logits at positions P-1 .. len(seq)-1."""
    with torch.no_grad():
        out = M.forward(params, cfg, {"tokens": seq[None, :P]}, mode="prefill")
        logits = [out.logits[0, -1]]
        cache = seed_cache(cfg, M.init_cache(cfg, 1, len(seq) + 1,
                                             device="cpu"), out.cache, P)
        for pos in range(P, len(seq)):
            o = M.forward(params, cfg, {"token": seq[None, pos:pos + 1],
                                        "cache": cache, "cache_index": pos},
                          mode="decode")
            logits.append(o.logits[0, 0])
    return torch.stack(logits)


def test_small_config_keeps_every_kind_of_layer(small):
    cfg, _, params = small
    assert is_mla(cfg) and cfg.first_k_dense == 1
    assert cfg.num_layers - cfg.first_k_dense >= 2
    assert cfg.experts_per_token < cfg.num_experts
    assert set(params["blocks"]) == {"dense", "moe"}


def test_prefill_and_decode_match_the_reference(small):
    cfg, sizes, params = small
    g = torch.Generator().manual_seed(5)
    P, seq = 40, torch.randint(0, cfg.vocab_size, (46,), generator=g)
    port = _port_logits(cfg, params, seq, P)
    want = mla_moe.logits(params, sizes, [seq],
                          [torch.arange(P - 1, len(seq))])[0]
    assert float((port - want).abs().max()) <= LOGIT_TOL * float(
        want.abs().max())
    # the fp8 control reads far further from the reference
    ctl = mla_moe.logits(params, sizes, [seq], [torch.arange(P - 1, len(seq))],
                         control=True)[0]
    assert float((ctl - want).abs().max()) > 100 * float(
        (port - want).abs().max())


def test_engine_serves_the_reference_tokens(small):
    """Requests of different lengths through the continuous engine (per-slot
    lengths, the latent cache spliced by slot): every served token is the
    reference's best to within the logit tolerance."""
    cfg, sizes, params = small
    rng = np.random.default_rng(7)
    reqs = [ServeRequest(uid=i, prompt=rng.integers(0, cfg.vocab_size, (P,))
                         .astype(np.int32), max_new=n)
            for i, (P, n) in enumerate([(24, 6), (24, 3), (24, 8), (24, 5)])]
    eng = ContinuousServingEngine(cfg, params, slots=2, max_len=40,
                                  macro_steps=4, device="cpu")
    outs, _ = eng.run(reqs)
    assert sorted(o.uid for o in outs) == [0, 1, 2, 3]
    for o in outs:
        r = reqs[o.uid]
        assert len(o.tokens) == r.max_new
        seq = torch.as_tensor(np.concatenate([r.prompt, o.tokens[:-1]])
                              .astype(np.int64))
        want = mla_moe.logits(params, sizes, [seq], [
            torch.arange(len(r.prompt) - 1, len(seq))])[0]
        served = torch.as_tensor(o.tokens.astype(np.int64))
        gap = want.max(-1).values - want.gather(-1, served[:, None])[:, 0]
        assert float(gap.max()) <= LOGIT_TOL * float(want.abs().max())


def test_absorbed_decode_equals_expanded_attention(small):
    """The decode's absorbed query over the latent rows gives what the
    prefill's expanded attention gives at the last position."""
    cfg, _, params = small
    p = {k: v[1] if torch.is_tensor(v) else {n: t[1] for n, t in v.items()}
         for k, v in params["blocks"]["moe"]["attn"].items()}
    g = torch.Generator().manual_seed(9)
    x = torch.randn((2, 11, cfg.d_model), generator=g)
    pos = torch.arange(11)
    full, rows = attention.mla_apply(p, x, cfg, positions=pos, mode="full")
    cache = {"latent": torch.zeros((2, 16, cfg.latent_dim))}
    cache["latent"][:, :10] = rows["latent"][:, :10]
    idx = torch.tensor([10, 10])
    dec, new = attention.mla_apply(p, x[:, 10:], cfg, positions=idx[:, None],
                                   mode="decode", cache=cache, cache_index=idx)
    assert torch.allclose(new["latent"][:, 10], rows["latent"][:, 10],
                          atol=1e-6)
    assert float((dec[:, 0] - full[:, 10]).abs().max()) <= OUT_TOL * float(
        full.abs().max())


def _moe_layer(small, bias=None):
    cfg, _, params = small
    p = {k: v[0] if torch.is_tensor(v) else {n: t[0] for n, t in v.items()}
         for k, v in params["blocks"]["moe"]["moe"].items()}
    if bias is not None:
        p["router_bias"] = bias
    return cfg, p


def _loop_reference(p, h, cfg):
    """The reference's MoE (a loop per expert over the tokens that chose
    it) on the port's layer params."""
    sizes = common.sizes(SMALL)
    return mla_moe._moe(h, p, sizes, common.matmul(False))


def test_nothing_dropped_when_the_bias_forces_one_expert(small):
    """A bias of 100 on expert 0 puts every token on it: its buffer rows are
    all T tokens, and the output is the loop reference's."""
    cfg, p = _moe_layer(small, bias=torch.tensor([100.0] + [0.0] * 7))
    g = torch.Generator().manual_seed(13)
    x = torch.randn((3, 17, cfg.d_model), generator=g)
    w, ids = moe.route_biased(x.reshape(-1, cfg.d_model), p["router"],
                              p["router_bias"], cfg)
    assert bool((ids == 0).any(-1).all())
    y, aux = moe.moe_apply(p, x, cfg)
    want = _loop_reference(p, x.reshape(-1, cfg.d_model), cfg)
    assert float(aux) == 0.0
    assert float((y.reshape(-1, cfg.d_model) - want).abs().max()) <= \
        OUT_TOL * float(want.abs().max())


@pytest.mark.parametrize("chunk,forced", [(7, False), (16, True), (51, False)])
def test_dropless_chunks_give_the_whole_batch_output(small, monkeypatch,
                                                     chunk, forced):
    """Dispatched in chunks of ``chunk`` tokens (51 = all of them), each
    expert's buffer holds a chunk's tokens and no more, the output is the
    loop reference's, and nothing is dropped even with every token forced
    onto expert 0."""
    cfg, p = _moe_layer(small, bias=torch.tensor([100.0] + [0.0] * 7)
                        if forced else None)
    monkeypatch.setattr(moe, "DROPLESS_TOKENS", chunk)
    rows = []
    ffn = ops.grouped_ffn
    monkeypatch.setattr(ops, "grouped_ffn", lambda buf, *a, **k: (
        rows.append(buf.shape[1]), ffn(buf, *a, **k))[1])
    g = torch.Generator().manual_seed(19)
    x = torch.randn((3, 17, cfg.d_model), generator=g)
    y, _ = moe.moe_apply(p, x, cfg)
    want = _loop_reference(p, x.reshape(-1, cfg.d_model), cfg)
    assert rows == [min(chunk, 51 - i) for i in range(0, 51, chunk)]
    assert float((y.reshape(-1, cfg.d_model) - want).abs().max()) <= \
        OUT_TOL * float(want.abs().max())


def test_bias_changes_the_choices_not_the_weights(small):
    cfg, p = _moe_layer(small)
    g = torch.Generator().manual_seed(17)
    xt = torch.randn((64, cfg.d_model), generator=g)
    w, ids = moe.route_biased(xt, p["router"], p["router_bias"], cfg)
    w0, ids0 = moe.route_biased(xt, p["router"], torch.zeros_like(
        p["router_bias"]), cfg)
    assert bool((ids.sort(-1).values != ids0.sort(-1).values).any())
    scores = torch.sigmoid(xt @ p["router"])
    chosen = scores.gather(-1, ids)
    assert torch.allclose(w, chosen / chosen.sum(-1, keepdim=True)
                          * cfg.routed_scaling, atol=1e-6)
    assert torch.allclose(w.sum(-1), torch.full((64,), cfg.routed_scaling),
                          atol=1e-5)


def _sorted_case(kind, E=8, D=32, F=16, seed=5):
    """Rows sorted by expert and their offsets for a routing ``kind``:
    random counts, some experts empty, every row on one expert, or a row
    count that is no multiple of the kernel's 128-row tile."""
    g = torch.Generator().manual_seed(seed)
    counts = {"random": torch.randint(1, 40, (E,), generator=g),
              "empty": torch.tensor([0, 37, 0, 0, 129, 5, 0, 1]),
              "one": torch.tensor([0, 0, 0, 300, 0, 0, 0, 0]),
              "ragged": torch.tensor([128, 3, 0, 131, 1, 0, 0, 64])}[kind]
    offsets = torch.zeros(E + 1, dtype=torch.int32)
    offsets[1:] = torch.cumsum(counts, 0)
    R = int(offsets[-1])
    xs = torch.randn((R, D), generator=g)
    w = [torch.randn(shape, generator=g) / math.sqrt(shape[1])
         for shape in ((E, D, F), (E, D, F), (E, F, D))]
    return xs, w, offsets, counts


@pytest.mark.parametrize("kind", ["random", "empty", "one", "ragged"])
def test_sorted_plain_version_equals_the_capacity_buffer(kind):
    """ref.grouped_ffn_sorted_ref over sorted rows equals grouped_ffn_ref
    over the [E, C, D] buffer that holds the same rows, expert by expert."""
    xs, w, offsets, counts = _sorted_case(kind)
    E, C = len(counts), max(int(counts.max()), 1)
    buf = torch.zeros((E, C, xs.shape[1]))
    for e in range(E):
        buf[e, :counts[e]] = xs[offsets[e]:offsets[e + 1]]
    want = ref.grouped_ffn_ref(buf, *w, counts.to(torch.int32))
    got = ref.grouped_ffn_sorted_ref(xs, *w, offsets)
    assert got.shape == xs.shape and got.dtype == xs.dtype
    for e in range(E):
        assert torch.allclose(got[offsets[e]:offsets[e + 1]],
                              want[e, :counts[e]], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("forced", [False, True])
def test_dropless_sorted_route_equals_the_loop_and_the_chunks(
        small, monkeypatch, forced):
    """With the sorted route taken (on the CPU its kernel's plain version
    runs), the dropless layer is one grouped_ffn_sorted over the T·K rows
    and no capacity buffer, and its output is the loop reference's and the
    chunked route's, also with every token forced onto expert 0."""
    cfg, p = _moe_layer(small, bias=torch.tensor([100.0] + [0.0] * 7)
                        if forced else None)
    g = torch.Generator().manual_seed(23)
    x = torch.randn((3, 17, cfg.d_model), generator=g)
    chunked, _ = moe.moe_apply(p, x, cfg)
    calls = []
    for name in ("grouped_ffn", "grouped_ffn_sorted"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append((_n, a[0].shape)), _f(*a, **k))[1])
    monkeypatch.setattr(moe, "sorted_route", lambda *a: True)
    y, aux = moe.moe_apply(p, x, cfg)
    want = _loop_reference(p, x.reshape(-1, cfg.d_model), cfg)
    assert calls == [("grouped_ffn_sorted",
                      (51 * cfg.experts_per_token, cfg.d_model))]
    assert float(aux) == 0.0
    for other in (want, chunked.reshape(-1, cfg.d_model)):
        assert float((y.reshape(-1, cfg.d_model) - other).abs().max()) <= \
            OUT_TOL * float(other.abs().max())


def test_sorted_route_rule(small, monkeypatch):
    """The sorted route takes a dropless layer's prefill-sized bf16 call
    with kernels on and no gradient (on the card: here the device check is
    set aside), and sends decode-sized T, a gradient, f32, kernels off and
    the softmax router to the capacity kernel."""
    from repro_torch.kernels import grouped_ffn as gf
    cfg, p = _moe_layer(small)
    real = gf.sorted_refusal
    assert real(torch.zeros(4, 8, dtype=torch.bfloat16),
                torch.zeros(2, 8, 16, dtype=torch.bfloat16)) == gf.OFF_CARD
    monkeypatch.setattr(moe, "sorted_refusal", lambda xs, wg: (
        None if real(xs, wg) == gf.OFF_CARD else real(xs, wg)))
    wg = p["w_gate"].bfloat16()
    E, K = cfg.num_experts, cfg.experts_per_token
    T_min = -(-moe.SORTED_ROWS_PER_EXPERT * E // K)   # the fewest it takes

    def takes(T, dtype=torch.bfloat16, grad=False, c=cfg, kernels=True):
        xt = torch.zeros((T, cfg.d_model), dtype=dtype, requires_grad=grad)
        return moe.sorted_route(xt, wg.to(dtype), c, kernels)

    assert takes(T_min) and takes(7168)
    assert not takes(T_min - 1)                    # decode-sized
    assert not takes(7168, grad=True)
    with torch.no_grad():
        assert takes(7168, grad=True)              # no gradient recorded
    assert not takes(7168, dtype=torch.float32)
    assert not takes(7168, kernels=False)
    assert not takes(7168, c=dataclasses.replace(cfg, routing="softmax"))
    # the cell's decode (64 slots: 6 rows an expert) stays off the route,
    # its 7,168-token prefill (672) takes it
    full = get_config(ARCH)
    decode, prefill = (T * full.experts_per_token / full.num_experts
                       for T in (64, 7168))
    assert decode < moe.SORTED_ROWS_PER_EXPERT <= prefill


def test_sorted_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.grouped_ffn import grouped_ffn_sorted_cuda
    xs, w, offsets, _ = _sorted_case("random")
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="not a CUDA device"):
        grouped_ffn_sorted_cuda(xs.bfloat16(), *(t.bfloat16() for t in w),
                                offsets)
    ops.grouped_ffn_sorted(xs, *w, offsets)       # the plain version
    assert ops.launch_counts()["grouped_ffn_sorted"] == 0


def test_sorted_cost_counts_the_rows_and_the_experts_used():
    c = costs.grouped_ffn_sorted(43008, 64, 2048, 1408, 2, experts_used=60)
    assert c["flops"] == 6 * 43008 * 2048 * 1408
    assert c["bytes"] == 2 * (2 * 43008 * 2048 + 60 * 3 * 2048 * 1408) \
        + 4 * 65
    assert costs.grouped_ffn_sorted(10, 4, 8, 8, 2)["bytes"] == \
        2 * (2 * 10 * 8 + 4 * 3 * 8 * 8) + 4 * 5


def _decode_inputs(B=3, H=16, S=70, W=576, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(21)
    return (torch.randn((B, H, W), generator=g).to(dtype),
            torch.randn((B, S, W), generator=g).to(dtype))


@pytest.mark.parametrize("case,reason", [
    ({"grad": True}, "a gradient is wanted"),
    ({"dtype": torch.float32}, "not bfloat16"),
    ({"W": 320}, "rows of 320"),
    ({"v_dim": 256}, "with V 256"),
    ({"H": 17}, "17 heads"),
    ({"B": 0}, "no slot or no row"),
    ({}, mk.OFF_CARD),
])
def test_mla_decode_refusal(case, reason):
    """Each condition of the kernel's route on its own: only a grad-free
    bf16 call over 576-wide rows with V their first 512, at most 16 heads,
    on one CUDA device, takes the kernel."""
    v_dim = case.pop("v_dim", 512)
    grad = case.pop("grad", False)
    q, lat = _decode_inputs(**case)
    if grad:
        q = q.float().requires_grad_(True).bfloat16()
    why = mk.refusal(q, lat, v_dim)
    assert why is not None and reason in why


def test_mla_decode_wrapper_refuses_cpu_tensors():
    ops.reset_launch_counts()
    q, lat = _decode_inputs()
    with pytest.raises(ValueError, match="not a CUDA device"):
        mk.mla_decode_attention_cuda(q, lat, 5, scale=0.1)
    assert ops.launch_counts()["mla_decode_attention"] == 0


def test_mla_decode_plain_version_is_the_per_slot_softmax():
    """The plain version against a softmax written slot by slot, head by
    head: keys the whole rows, values their first 512, each slot's own
    length (an empty slot gives 0); ``ops`` on the CPU takes it."""
    q, lat = _decode_inputs(dtype=torch.float32)
    lens = torch.tensor([70, 9, 0])
    got = ops.mla_decode_attention(q, lat, lens, scale=0.07, v_dim=512)
    assert ops.launch_counts()["mla_decode_attention"] == 0
    for b in range(3):
        n = int(lens[b])
        if n == 0:
            assert not bool(got[b].any())
            continue
        p = torch.softmax(q[b] @ lat[b, :n].T * 0.07, dim=-1)
        assert torch.allclose(got[b], p @ lat[b, :n, :512], atol=1e-5)
    assert torch.equal(got, ref.mla_decode_attention_ref(q, lat, lens,
                                                         scale=0.07,
                                                         v_dim=512))


@pytest.mark.parametrize("B,S", [(64, 7272), (1, 200), (3, 5000),
                                 (128, 300000)])
def test_mla_decode_splits_cover_the_rows(B, S):
    splits, rows = mk.num_splits(B, S)
    assert rows % mk.TILE_ROWS == 0 and 1 <= splits <= mk.MAX_SPLITS
    assert (splits - 1) * rows < S <= splits * rows
    assert rows >= min(mk.MIN_SPLIT_ROWS, -(-S // mk.TILE_ROWS) * mk.TILE_ROWS)


def test_mla_decode_cost_counts_the_rows_it_must_read():
    """Each latent row once, whole: 1,152 bytes a bf16 row; q read, out
    written, the lengths read; two products a row and head."""
    c = costs.mla_decode_attention(64, 16, 576, 512, 64 * 7200, 2)
    assert c["bytes"] == 64 * 7200 * 1152 + 64 * 16 * (576 + 512) * 2 + 64 * 4
    assert c["flops"] == 2 * 16 * 64 * 7200 * (576 + 512)
    frozen = mla_moe.mla_decode_cost(64, 16, 576, 512, 64 * 7200, 2)
    assert frozen == c


def test_prefill_plan_for_the_mla_widths():
    """The q/k 192, v 128 instance: taken, its shared memory (q tile and K
    ring of 192-wide rows, V ring of 128-wide ones, the visit list) by hand,
    two blocks an SM at a 7,168-token prompt; other pairs refused."""
    assert pa.takes_widths(192, 128)
    assert not pa.takes_widths(192, 192) and not pa.takes_widths(128, 192)
    assert all(pa.takes_widths(d, d) for d in pa.HEAD_DIMS)
    need = pa.smem_bytes(192, 7168, 128)
    assert need == (64 + 2 * 64) * (2 * 192 + 16) + 2 * 64 * (2 * 128 + 16) \
        + 4 * 112
    assert 2 * (need + 1024) <= 228 * 1024
    assert pa.smem_bytes(128, 2048) == pa.smem_bytes(128, 2048, 128)
    q = torch.zeros((1, 8, 16, 192), dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 16, 128), dtype=torch.bfloat16)
    assert pa.refusal(q, q, v) == pa.OFF_CARD
    assert "head_dim 192" in pa.refusal(q, q, q)
    c = costs.prefill_attention(1, 7168, 7168, 16, 16, 192, True, 0, dv=128)
    pairs = 7168 * 7169 // 2
    assert c["flops"] == 2 * 16 * (192 + 128) * pairs
    assert c["bytes"] == 2 * (7168 * 16 * 320 * 2)
    assert c == mla_moe.prefill_attention_cost(7168, 16, 192, 128, 2)


def test_prefill_takes_the_kernel_route_on_the_card(small, monkeypatch):
    """With kernels on, every MLA prefill layer of a bf16 model at the
    published head widths hands the kernel q and k of 192 and v of 128
    (here the route's only missing condition, the card, is granted and the
    plain version stands in); the test's own widths keep the plain path."""
    cfg, _, _ = small
    calls = []
    refusal = pa.refusal
    monkeypatch.setattr(pa, "refusal", lambda q, k, v: (
        None if refusal(q, k, v) == pa.OFF_CARD else refusal(q, k, v)))

    def fake(q, k, v, **kw):
        calls.append((q.shape, k.shape, v.shape))
        return attention.chunked_attention(q, k, v, **kw)
    monkeypatch.setattr(ops, "prefill_attention", fake)
    wide = dataclasses.replace(cfg, qk_nope_head_dim=128, qk_rope_head_dim=64,
                               v_head_dim=128, dtype="bfloat16")
    x = torch.randint(0, cfg.vocab_size, (1, 20))
    with torch.no_grad():
        M.forward(M.init_params(wide, 0, device="cpu"), wide, {"tokens": x},
                  mode="prefill", use_kernels=True)
        assert calls == [((1, 20, 4, 192), (1, 20, 4, 192),
                          (1, 20, 4, 128))] * 3
        calls.clear()
        M.forward(_bf16(small[2]), dataclasses.replace(cfg, dtype="bfloat16"),
                  {"tokens": x}, mode="prefill", use_kernels=True)
    assert calls == []


def _bf16(tree, key=""):
    """The served dtypes: bf16 weights, the router, its bias and the norm
    scales in float32."""
    if isinstance(tree, dict):
        return {k: _bf16(v, k) for k, v in tree.items()}
    keep = key in ("router", "router_bias", "scale")
    return tree if keep else tree.to(torch.bfloat16)


def test_what_mla_refuses(small):
    cfg, _, params = small
    from repro_torch.launch import mesh as tmesh
    from repro_torch.serving.prefill import PrefillWorker
    from repro_torch.serving.prefix_cache import PrefixCache
    with pytest.raises(ValueError, match="prefix cache"):
        PrefixCache(cfg, device="cpu")
    with pytest.raises(ValueError, match="KV hop"):
        PrefillWorker(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="not quantized"):
        M.init_cache(dataclasses.replace(cfg, kv_quant="int8"), 1, 8,
                     device="cpu")
    view = tmesh.Mesh(np.arange(4).reshape(2, 2), ("data", "model"),
                      view=True)
    with sharding.activation_sharding(view):
        with pytest.raises(ValueError, match="meshes are not supported"):
            M.init_cache(cfg, 2, 8, device="cpu")
        with pytest.raises(ValueError, match="meshes are not supported"):
            M.forward(params, cfg, {"tokens": torch.zeros((2, 4), dtype=torch.long)},
                      mode="prefill")
    with pytest.raises(ValueError, match="prefix resume"):
        M.forward(params, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.long),
                                "prefix": M.init_cache(cfg, 1, 2, device="cpu")},
                  mode="prefill")


def test_param_count_is_the_layout_and_the_published_16b(small):
    cfg, _, params = small
    assert sum(t.numel() for t in tree_leaves(params)) == cfg.param_count()
    full = get_config(ARCH)
    meta = M.init_params(full, 0, device="meta")
    n = sum(t.numel() for t in tree_leaves(meta))
    assert n == full.param_count() == 15_960_110_208
    assert 2.5e9 < full.active_param_count() < 3.5e9
    assert ARCH in list_configs()
    r = reduced(full)
    assert is_mla(r) and r.first_k_dense == 1 and r.num_layers == 2


def test_the_plain_path_is_differentiable(small):
    """Training's forward through the plain path: every weight gets a
    gradient but the routing bias, which only selects."""
    cfg, _, params = small
    p = {k: v for k, v in params.items()}
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    try:
        tokens = torch.randint(0, cfg.vocab_size, (2, 12))
        out = M.forward(p, cfg, {"tokens": tokens}, mode="train")
        loss = M.cross_entropy(out.logits[:, :-1], tokens[:, 1:])
        loss.backward()
        bias = p["blocks"]["moe"]["moe"]["router_bias"]
        missing = [t.shape for t in leaves if t.grad is None and t is not bias]
        assert not missing and bias.grad is None
        assert math.isfinite(float(loss.detach()))
    finally:
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)


def test_mla_spans_nest_in_the_model_steps(small):
    """Recording on, the engine's prefills and decode steps open the MLA
    and MoE spans inside ``model.prefill`` and ``model.decode_step``: one
    attention span a layer a step, the three MoE spans once a MoE layer."""
    from repro_torch import tracing
    cfg, _, params = small
    rng = np.random.default_rng(3)
    reqs = [ServeRequest(uid=i, prompt=rng.integers(0, cfg.vocab_size, (12,))
                         .astype(np.int32), max_new=4) for i in range(2)]
    eng = ContinuousServingEngine(cfg, params, slots=2, max_len=20,
                                  macro_steps=4, device="cpu")
    with tracing.recording() as rec:
        eng.run(reqs)
    prefills = len(rec.named("model.prefill"))
    steps = len(rec.named("model.decode_step"))
    n_moe = cfg.num_layers - cfg.first_k_dense
    assert len(rec.named("attention.mla_prefill")) == cfg.num_layers * prefills
    assert len(rec.named("attention.mla_decode")) == cfg.num_layers * steps
    for name in ("moe.route", "moe.experts", "moe.shared"):
        assert len(rec.named(name)) == n_moe * (prefills + steps)
    for r in rec.spans:
        if r.name.startswith(("attention.mla", "moe.")):
            assert rec.spans[r.parent].name in ("model.prefill",
                                                "model.decode_step")


def test_chip_smoke_counts_the_latent_path():
    """chip_smoke's launch expectation for moonlight: latent decode
    attention in all 27 layers, no decode_attention, grouped_ffn in the 26
    MoE layers of each decode step, grouped_ffn_sorted in those of each
    7,168-token prefill (a prompt too short for the sorted route takes
    grouped_ffn in 2,048-token chunks); its kernels line counts the 192/128
    instance's launches on moonlight's paths alone."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    cfg = get_config("moonlight-16b-a3b")
    want = cs._expected_launches(cfg, {"decode_steps": 5, "prefills": 2}, 7168)
    assert want == {"decode_attention": 0, "mla_decode_attention": 27 * 5,
                    "grouped_ffn": 26 * 5, "grouped_ffn_sorted": 26 * 2,
                    "ssm_scan": 0, "ssm_scan_bwd": 0}
    short = cs._expected_launches(cfg, {"decode_steps": 5, "prefills": 2}, 64)
    assert (short["grouped_ffn"], short["grouped_ffn_sorted"]) == \
        (26 * (5 + 2), 0)
    row = {"ms": 1.0, "device_ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
           "bound_by": "memory", "library_ms": None, "group": "cell"}
    rows = [dict(row, kernel=k) for k in cs.KERNEL_META]
    counts = {k: 3 for k in ops.launch_counts()}
    line = {e["name"]: e for e in cs.kernels_line(
        rows, {"llama3.2-1b": counts,
               f"{cs.MLA_ARCH} continuous overlapped": dict(
                   counts, prefill_attention=54)}, [{}])}
    assert line[cs.MLA_PREFILL]["launches_by_path"] == {
        f"{cs.MLA_ARCH} continuous overlapped": 54}
    assert line["prefill_attention"]["launches"] == 3 + 54
    assert line["mla_decode_attention"]["launches"] == 6
