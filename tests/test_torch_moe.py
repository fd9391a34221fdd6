"""The port's MoE family against the JAX package on the CPU: the configs
field for field, ``moe_apply`` against ``_moe_global`` (also under capacity
overflow), prefill and decode logits of reduced moonshot, qwen3-moe and
mixtral, greedy streams of ``ServingEngine``, and the launcher end to end.
JAX params are handed over with ``repro_torch.convert``; inputs come from
numpy at the suite seed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _hypothesis_compat import given, settings, strategies as st  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.serving.engine import seed_cache as jseed_cache  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import layer_slice  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

MOE_ARCHS = ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b", "mixtral-8x22b"]
MOONSHOT = "moonshot-v1-16b-a3b"
TOL = 1e-4


def _pair(arch, **overrides):
    """(jax cfg, jax params, port cfg, port params) for reduced ``arch``."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **overrides)
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(reduced(get_config(arch)), **overrides)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                       device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def moonshot():
    return _pair(MOONSHOT)


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_match_field_for_field(arch):
    full, jfull = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(reduced(full)) == dataclasses.asdict(jreduced(jfull))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's random init builds JAX's tree: same keys, shapes, dtypes
    (the router in f32, the shared expert where the config has one)."""
    jcfg = jreduced(jget_config(arch))
    want = _shapes(jax.eval_shape(lambda: jM.init_params(jcfg, jax.random.PRNGKey(0))))
    got = _shapes(M.init_params(reduced(get_config(arch)), 0, device="cpu"))
    assert got == want
    assert got["blocks.moe.router"][1] == "float32"
    assert ("blocks.moe.shared.w_gate" in got) == bool(jcfg.num_shared_experts)


def test_convert_checks_moe_leaves(moonshot):
    _, jparams, cfg, _ = moonshot
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="shared expert"):
        convert.params_from_numpy(tree, dataclasses.replace(cfg, num_shared_experts=0),
                                  device="cpu")
    with pytest.raises(ValueError, match="w_gate"):
        convert.params_from_numpy(tree, dataclasses.replace(cfg, d_ff=cfg.d_ff + 8),
                                  device="cpu")


def _jax_kept_pairs(x2d, router, cfg, C):
    """The (token, expert) choices ``_moe_global`` keeps, by its own lines
    (moe.py: top_k, stable jnp.argsort, bincount offsets, pos < C)."""
    T, K, E = x2d.shape[0], cfg.experts_per_token, cfg.num_experts
    logits = jnp.einsum("td,de->te", jnp.asarray(x2d), router)
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    flat = ids.reshape(-1)
    sort_idx = jnp.argsort(flat)
    sorted_ids = flat[sort_idx]
    counts = jnp.bincount(flat, length=E)
    offsets = jnp.concatenate([jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)[:-1]])
    keep = np.asarray(jnp.arange(T * K) - offsets[sorted_ids] < C)
    return set(zip(np.asarray(sort_idx // K)[keep].tolist(),
                   np.asarray(sorted_ids)[keep].tolist()))


@pytest.mark.parametrize("capacity_factor", [None, 0.5], ids=["ample", "overflow"])
def test_moe_apply_matches_moe_global(capacity_factor, test_seed):
    """y within 1e-5 and aux within 1e-6 of JAX; with capacity factor 0.5
    tokens overflow and the kept (token, expert) set is JAX's exactly,
    which needs the stable sort."""
    over = {} if capacity_factor is None else {"moe_capacity_factor": capacity_factor}
    jcfg, jparams, cfg, params = _pair(MOONSHOT, **over)
    rng = np.random.default_rng(test_seed)
    B, S = 2, 32
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    tp = layer_slice(params["blocks"]["moe"], 0)
    jy, jaux = jmoe._moe_global(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6

    T, E, K = B * S, cfg.num_experts, cfg.experts_per_token
    C = moe._capacity(T, cfg)
    assert C == jmoe._capacity(T, jcfg)
    xt = torch.from_numpy(x.reshape(T, -1))
    _, ids, _, _ = moe.route(xt, tp["router"], cfg)
    _, sorted_ids, _, keep, src, _ = moe.dispatch(ids, E, C)
    mine = set(zip(src[keep].tolist(), sorted_ids[keep].tolist()))
    want = _jax_kept_pairs(x.reshape(T, -1), jp["router"], jcfg, C)
    assert mine == want
    if capacity_factor is None:
        assert len(want) == T * K
    else:
        assert len(want) < T * K            # some choices overflowed


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_prefill_and_decode_logits(arch, test_seed):
    """Prefill and decode (scalar and per-slot cache_index) logits and the
    router aux within 1e-4 of JAX.  mixtral's prompt outgrows its reduced
    window of 64, so the window masks in prefill and in decode."""
    jcfg, jparams, cfg, params = _pair(arch)
    rng = np.random.default_rng(test_seed)
    B = 2
    P = 70 if cfg.sliding_window else 9
    S = P + 8
    if cfg.sliding_window:
        assert cfg.sliding_window < P
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    jout = jM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, mode="prefill")
    out = M.forward(params, cfg, {"tokens": torch.from_numpy(toks)}, mode="prefill")
    np.testing.assert_allclose(_np(out.logits), np.asarray(jout.logits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(out.aux_loss), float(jout.aux_loss),
                               rtol=TOL, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(out.cache["self"][name]),
                                   np.asarray(jout.cache["self"][name]),
                                   rtol=TOL, atol=TOL)

    jcache = jseed_cache(jcfg, jM.init_cache(jcfg, B, S), jout.cache, P)
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    for idx in (np.int32(P), np.array([P, P - 3], np.int32)):
        jdec = jM.forward(jparams, jcfg, {"token": jnp.asarray(nxt), "cache": jcache,
                                          "cache_index": jnp.asarray(idx)},
                          mode="decode")
        cache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
        dec = M.forward(params, cfg, {"token": torch.from_numpy(nxt), "cache": cache,
                                      "cache_index": torch.from_numpy(np.asarray(idx))},
                        mode="decode")
        np.testing.assert_allclose(_np(dec.logits), np.asarray(jdec.logits),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(dec.aux_loss), float(jdec.aux_loss),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("macro_steps", [0, 8])
def test_moonshot_generate_matches_jax(moonshot, macro_steps, test_seed):
    """Greedy streams of the port's ServingEngine equal JAX's on reduced
    moonshot (float32), per-token and fused."""
    jcfg, jparams, cfg, params = moonshot
    rng = np.random.default_rng(test_seed)
    prompts = rng.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    max_new = 11
    want = JServingEngine(jcfg, jparams, max_len=32,
                          macro_steps=macro_steps).generate(prompts, max_new)
    got = ServingEngine(cfg, params, max_len=32, macro_steps=macro_steps,
                        device="cpu").generate(prompts, max_new)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.host_syncs == want.host_syncs


def test_launcher_moonshot_static_split_on_cpu():
    """``--arch moonshot-v1-16b-a3b --split auto`` end to end on the CPU:
    every request gets its tokens, the summary counts one prefill per
    generate() call, and no kernel is launched."""
    ops.reset_launch_counts()
    s = serve.main(["--arch", MOONSHOT, "--reduced", "--device", "cpu",
                    "--split", "auto", "--requests", "5", "--prompt-len", "12",
                    "--max-new", "5", "--macro-steps", "4"])
    assert s["tokens"].shape == (5, 5)
    assert 0 <= int(s["tokens"].min()) and int(s["tokens"].max()) < 512
    assert 0.0 < s["r_star"] < 1.0 and sum(s["n_group"]) == 5
    engines = 1 + sum(1 for n in s["n_group"] if n)     # the probe + groups
    assert s["prefills"] == engines
    assert s["decode_steps"] == engines * 4
    assert set(ops.launch_counts().values()) == {0}


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10**6), capacity_factor=st.floats(0.25, 2.0))
def test_moe_apply_counts_bound_buffer_rows(moonshot, seed, capacity_factor):
    """Over random routings, overflow included: the counts moe_apply hands
    the expert FFN are min(choices, C) per expert and bound the non-zero
    rows of its buffer, the output is bit for bit the one without counts,
    and it matches JAX's _moe_global."""
    jcfg, jparams, cfg, params = moonshot
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=capacity_factor)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity_factor)
    rng = np.random.default_rng(seed)
    B, S = 2, 16
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    tp = layer_slice(params["blocks"]["moe"], 0)
    seen, ffn = [], ops.grouped_ffn

    def spy(buf, wg, wu, wd, *, counts=None, use_kernels=True):
        seen.append((buf, counts))
        return ffn(buf, wg, wu, wd, counts=counts, use_kernels=use_kernels)

    def no_counts(buf, wg, wu, wd, *, counts=None, use_kernels=True):
        return ffn(buf, wg, wu, wd, use_kernels=use_kernels)

    try:
        ops.grouped_ffn = spy
        y, _ = moe.moe_apply(tp, torch.from_numpy(x), cfg)
        ops.grouped_ffn = no_counts
        y_all, _ = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    finally:
        ops.grouped_ffn = ffn
    (buf, counts), = seen
    E, C = buf.shape[:2]
    assert counts.dtype == torch.int32 and tuple(counts.shape) == (E,)
    _, ids, _, _ = moe.route(torch.from_numpy(x.reshape(B * S, -1)),
                             tp["router"], cfg)
    choices = torch.bincount(ids.reshape(-1), minlength=E)
    assert torch.equal(counts.long(), choices.clamp(max=C))
    past = torch.arange(C)[None, :] >= counts[:, None]
    assert not bool(buf[past].any())
    assert torch.equal(y, y_all)
    jy, _ = jmoe._moe_global(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
