"""The port's model layers and forward pass against the JAX package, on
reduced llama3.2-1b in float32 with the JAX weights handed over through
``repro_torch.convert``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.serving.engine import seed_cache as jseed_cache  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port params) for reduced llama."""
    jcfg = jreduced(jget_config("llama3.2-1b"))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("llama3.2-1b"))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                       device="cpu")
    return jcfg, jparams, cfg, params


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def test_configs_match_field_for_field(pair):
    jcfg, _, cfg, _ = pair
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    full, jfull = get_config("llama3.2-1b"), jget_config("llama3.2-1b")
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.torch_dtype == torch.bfloat16 and cfg.torch_dtype == torch.float32


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm", "nonparametric"])
def test_norms_rope_embed(pair, norm_type, test_seed):
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(test_seed)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    p = {"scale": scale, "bias": scale[::-1].copy()} \
        if norm_type != "nonparametric" else {}
    c = dataclasses.replace(cfg, norm_type=norm_type)
    mine = layers.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), c)
    want = jlayers.norm_apply(p, jnp.asarray(x), c)
    np.testing.assert_allclose(_np(mine), np.asarray(want), rtol=1e-5, atol=1e-5)

    h = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    for pos in (np.arange(3, 8, dtype=np.int32),                  # prefill [S]
                np.array([[7], [30]], np.int32)):                   # per-slot [B,1]
        if pos.ndim == 2:
            h1 = h[:, :1]
        else:
            h1 = h
        mine = layers.apply_rope(torch.from_numpy(h1), torch.from_numpy(pos),
                                 cfg.rope_theta)
        want = jlayers.apply_rope(jnp.asarray(h1), jnp.asarray(pos), cfg.rope_theta)
        np.testing.assert_allclose(_np(mine), np.asarray(want), rtol=1e-5, atol=1e-5)

    tok = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    emb = layers.embed_apply(params["embed"], torch.from_numpy(tok))
    np.testing.assert_array_equal(
        _np(emb), np.asarray(jlayers.embed_apply(jparams["embed"], tok)))
    logits = layers.unembed_apply(None, emb, tied_table=params["embed"]["table"])
    want = jlayers.unembed_apply(None, jnp.asarray(_np(emb)),
                                 tied_table=jparams["embed"]["table"])
    np.testing.assert_allclose(_np(logits), np.asarray(want), rtol=TOL, atol=TOL)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("window,q_chunk,kv_chunk",
                         [(0, 512, 1024), (0, 5, 7), (4, 5, 7)],
                         ids=["one-chunk", "padded-chunks", "window"])
def test_qkv_and_chunked_attention(pair, window, q_chunk, kv_chunk, test_seed):
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(test_seed)
    S = 12
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jp = _layer0(jparams["blocks"]["attn"])
    tp = {k: v[0] for k, v in params["blocks"]["attn"].items()}
    jq, jk, jv = jattn._qkv(jp, jnp.asarray(x), jnp.asarray(x), jcfg, pos, pos,
                            rope=True)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    q, k, v = attn._qkv(tp, tx, tx, cfg, tpos, tpos, rope=True)
    for a, b in ((q, jq), (k, jk), (v, jv)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    mine = attn.chunked_attention(q, k, v, causal=True, window=window,
                                  q_positions=tpos, kv_positions=tpos,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk)
    want = jattn.chunked_attention(jq, jk, jv, causal=True, window=window,
                                   q_positions=jnp.asarray(pos),
                                   kv_positions=jnp.asarray(pos),
                                   q_chunk=q_chunk, kv_chunk=kv_chunk)
    np.testing.assert_allclose(_np(mine), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("index", [3, 99, [0, 5], [2, 99]],
                         ids=["scalar", "scalar-clamped", "per-slot",
                              "per-slot-clamped"])
def test_cache_update_matches_dynamic_update_slice(index, test_seed):
    rng = np.random.default_rng(test_seed)
    cache = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    new = rng.standard_normal((2, 1, 2, 16)).astype(np.float32)
    idx = np.asarray(index, np.int32)
    want = np.asarray(jattn.cache_update(jnp.asarray(cache), jnp.asarray(new),
                                         jnp.asarray(idx)))
    tc = torch.from_numpy(cache.copy())
    out = attn.cache_update(tc, torch.from_numpy(new), torch.from_numpy(idx))
    assert out is tc                                  # updated in place
    np.testing.assert_array_equal(_np(out), want)


def test_forward_prefill_and_decode_logits(pair, test_seed):
    """Prefill (last-position logits + caches) and one decode step with a
    scalar and with a per-slot [B] cache_index, within 1e-4 of JAX."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(test_seed)
    B, P, S = 3, 9, 16
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    jout = jM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, mode="prefill")
    out = M.forward(params, cfg, {"tokens": torch.from_numpy(toks)}, mode="prefill")
    np.testing.assert_allclose(_np(out.logits), np.asarray(jout.logits),
                               rtol=TOL, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(out.cache["self"][name]),
                                   np.asarray(jout.cache["self"][name]),
                                   rtol=TOL, atol=TOL)

    jcache = jseed_cache(jcfg, jM.init_cache(jcfg, B, S), jout.cache, P)
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    for idx in (np.int32(P), np.array([P, P - 2, P + 3], np.int32)):
        jdec = jM.forward(jparams, jcfg, {"token": jnp.asarray(nxt), "cache": jcache,
                                          "cache_index": jnp.asarray(idx)},
                          mode="decode")
        cache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
        dec = M.forward(params, cfg, {"token": torch.from_numpy(nxt), "cache": cache,
                                      "cache_index": torch.from_numpy(np.asarray(idx))},
                        mode="decode")
        np.testing.assert_allclose(_np(dec.logits), np.asarray(jdec.logits),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_np(dec.cache["self"]["k"]),
                                   np.asarray(jdec.cache["self"]["k"]),
                                   rtol=TOL, atol=TOL)
