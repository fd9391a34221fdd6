"""The int8 KV cache in the port against the JAX package, at reduced size
in float32 with the JAX weights handed over through ``repro_torch.convert``:
``quantize_kv``, seeded int8 caches, decode logits of the
tests/test_extensions.py cases (llama, zamba2, seamless), ServingEngine and
ContinuousServingEngine streams, and the launcher's ``--kv-int8``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import request_stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.serving.engine import (ContinuousServingEngine,  # noqa: E402
                                        ServeRequest, ServingEngine)

CPU = "cpu"
# tests/test_extensions.py's int8 cases
EXT_ARCHS = ["llama3.2-1b", "zamba2-2.7b", "seamless-m4t-medium"]


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


class Int8Pair:
    """One config with ``kv_quant="int8"`` at reduced size in both
    packages, the port's params converted from JAX's."""

    def __init__(self, arch: str):
        self.jcfg = dataclasses.replace(jreduced(jget_config(arch)), kv_quant="int8")
        self.cfg = dataclasses.replace(reduced(get_config(arch)), kv_quant="int8")
        self.jparams = jM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.params = convert.params_from_numpy(
            jax.tree.map(np.asarray, self.jparams), self.cfg, device=CPU)

    def batch(self, rng, B, S):
        toks = rng.integers(0, self.cfg.vocab_size, (B, S)).astype(np.int32)
        fe = None
        if self.cfg.frontend:
            fe = rng.standard_normal((B, self.cfg.frontend_tokens,
                                      self.cfg.frontend_dim)).astype(np.float32)
        return toks, fe


_PAIRS = {}


def pair_of(arch: str) -> Int8Pair:
    if arch not in _PAIRS:
        _PAIRS[arch] = Int8Pair(arch)
    return _PAIRS[arch]


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(_np, tree, is_leaf=torch.is_tensor))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 1, 2, 64), (2, 3, 7, 4, 16)],
                         ids=["decode-row", "prefill-cache"])
def test_quantize_kv_matches_jax(shape, test_seed):
    """The same int8 values as JAX's except where t/scale lies within 1e-4
    of a half-integer (round half to even on both sides, but a last-bit
    difference in t/scale may cross .5); scales within 1e-6 relative."""
    rng = np.random.default_rng(test_seed)
    t = (rng.standard_normal(shape) * rng.uniform(0.01, 10.0, shape[:-1] + (1,))
         ).astype(np.float32)
    t[(0,) * (len(shape) - 1)] = 0.0            # an all-zero row: amax floor
    jq, jsc = jattn.quantize_kv(jnp.asarray(t))
    q, sc = attn.quantize_kv(torch.from_numpy(t))
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    assert tuple(sc.shape) == shape[:-1] + (1,)
    np.testing.assert_allclose(_np(sc), np.asarray(jsc), rtol=1e-6, atol=0)
    ratio = t / np.asarray(jsc)
    near_half = np.abs(np.abs(ratio) % 1.0 - 0.5) < 1e-4
    diff = _np(q) != np.asarray(jq)
    assert not (diff & ~near_half).any()
    assert np.abs(_np(q).astype(np.int32) - np.asarray(jq).astype(np.int32)).max() <= 1


def test_quantize_kv_round_half_even_and_clip():
    t = torch.tensor([[[[127.0, 0.5, 1.5, -2.5, -127.0, 63.5]]]])
    q, sc = attn.quantize_kv(t)
    assert float(sc.flatten()[0]) == pytest.approx(1.0)
    assert q.flatten().tolist() == [127, 0, 2, -2, -127, 64]
    jq, _ = jattn.quantize_kv(jnp.asarray(t.numpy()))
    np.testing.assert_array_equal(_np(q), np.asarray(jq))


@pytest.mark.parametrize("arch", EXT_ARCHS)
def test_init_cache_layout_matches_jax(arch):
    p = pair_of(arch)
    want = jM.init_cache(p.jcfg, 2, 24)
    got = M.init_cache(p.cfg, 2, 24, device=CPU)
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(_np, got, is_leaf=torch.is_tensor))
    for a, b in zip(jax.tree.leaves(want), _leaves(got)):
        assert a.shape == b.shape and str(a.dtype) == str(b.dtype)


@pytest.mark.parametrize("arch", EXT_ARCHS)
def test_int8_seed_and_decode_match_jax(arch, test_seed):
    """tests/test_extensions.py's int8 cases against JAX: the prefill cache
    seeded into the int8 decode cache (the same int8 values, up to a near
    half-integer, and scales), then one decode step's logits within 1e-3 of
    max|logit| and the same greedy tokens."""
    p = pair_of(arch)
    rng = np.random.default_rng(test_seed)
    B, S = 2, 8
    toks, fe = p.batch(rng, B, S)
    jbatch = {"tokens": jnp.asarray(toks[:, :S - 1])}
    batch = {"tokens": torch.from_numpy(toks[:, :S - 1])}
    if fe is not None:
        jbatch["frontend"] = jnp.asarray(fe)
        batch["frontend"] = torch.from_numpy(fe)
    jpre = jM.forward(p.jparams, p.jcfg, jbatch, mode="prefill")
    pre = M.forward(p.params, p.cfg, batch, mode="prefill")
    jcache = jengine.seed_cache(p.jcfg, jM.init_cache(p.jcfg, B, S, dtype=jnp.float32),
                                jpre.cache, S - 1)
    cache = engine.seed_cache(p.cfg, M.init_cache(p.cfg, B, S, device=CPU),
                              convert.cache_from_numpy(
                                  jax.tree.map(np.asarray, jpre.cache), CPU), S - 1)
    for a, b in zip(jax.tree.leaves(jcache), _leaves(cache)):
        assert str(a.dtype) == str(b.dtype)
        if b.dtype == np.int8:
            assert np.abs(np.asarray(a).astype(np.int32) - b.astype(np.int32)).max() <= 1
            assert (np.asarray(a) == b).mean() > 0.999
        else:
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)
    jdec = jM.forward(p.jparams, p.jcfg,
                      {"token": jnp.asarray(toks[:, S - 1:]), "cache": jcache,
                       "cache_index": jnp.int32(S - 1)}, mode="decode")
    dec = M.forward(p.params, p.cfg,
                    {"token": torch.from_numpy(toks[:, S - 1:]), "cache": cache,
                     "cache_index": torch.tensor(S - 1, dtype=torch.int32)},
                    mode="decode")
    a, b = np.asarray(jdec.logits[:, 0]), _np(dec.logits[:, 0])
    assert np.abs(a - b).max() <= 1e-3 * np.abs(a).max()
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    # the int8 rows the step wrote at S - 1 match JAX's
    self_kv = cache["shared"]["self"] if "shared" in cache else cache["self"]
    jself = jdec.cache["shared"]["self"] if "shared" in jdec.cache \
        else jdec.cache["self"]
    assert self_kv["k"].dtype == torch.int8
    np.testing.assert_allclose(_np(self_kv["k_scale"])[:, :, S - 1],
                               np.asarray(jself["k_scale"])[:, :, S - 1],
                               rtol=1e-5)
    # the prefill logits themselves do not see the quantization
    np.testing.assert_allclose(_np(pre.logits), np.asarray(jpre.logits),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("macro_steps", [0, 8])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_int8_generate_matches_jax(arch, macro_steps, test_seed):
    """ServingEngine streams over the int8 cache identical to JAX's (the vlm
    and audio cases are in test_torch_families.py)."""
    p = pair_of(arch)
    rng = np.random.default_rng(test_seed + 5)
    prompts = rng.integers(0, p.cfg.vocab_size, (3, 9)).astype(np.int32)
    want = jengine.ServingEngine(p.jcfg, p.jparams, max_len=32,
                                 macro_steps=macro_steps).generate(prompts, 11)
    got = ServingEngine(p.cfg, p.params, max_len=32, macro_steps=macro_steps,
                        device=CPU).generate(prompts, 11)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.host_syncs == want.host_syncs


@pytest.mark.parametrize("mode", ["per-step", "boundary", "overlapped"])
def test_int8_continuous_matches_jax(mode, test_seed):
    """The continuous engine over int8 slots: every admission quantizes the
    B=1 prefill into its slot's rows (per-slot writes and the fused splice)."""
    kw = {"per-step": dict(macro_steps=0),
          "boundary": dict(macro_steps=4, overlap_admission=False),
          "overlapped": dict(macro_steps=4)}[mode]
    p = pair_of("llama3.2-1b")
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, p.cfg.vocab_size, (5, 8)).astype(np.int32)
    reqs = [ServeRequest(uid=i, prompt=prompts[i], max_new=m)
            for i, m in enumerate([1, 6, 3, 9, 4])]
    jouts, jstats = jengine.ContinuousServingEngine(
        p.jcfg, p.jparams, slots=2, max_len=32, **kw).run(
        [jengine.ServeRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new)
         for r in reqs])
    outs, stats = ContinuousServingEngine(p.cfg, p.params, slots=2, max_len=32,
                                          device=CPU, **kw).run(reqs)
    for a, b in zip(outs, jouts):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert (stats.total_tokens, stats.host_syncs, stats.macro_dispatches) == \
        (jstats.total_tokens, jstats.host_syncs, jstats.macro_dispatches)


def test_int8_splice_writes_match_jax(test_seed):
    """write_slot_cache and splice_slot_caches quantize B=1 prefill blocks
    into an int8 decode cache leaf for leaf as JAX's do (values up to a
    near half-integer, scales, untouched slots)."""
    p = pair_of("seamless-m4t-medium")
    rng = np.random.default_rng(test_seed)
    blocks, jblocks = [], []
    for _ in range(2):
        toks, fe = p.batch(rng, 1, 6)
        out = jM.forward(p.jparams, p.jcfg, {"tokens": jnp.asarray(toks),
                                             "frontend": jnp.asarray(fe)},
                         mode="prefill")
        jblocks.append(out.cache)
        blocks.append(convert.cache_from_numpy(jax.tree.map(np.asarray, out.cache),
                                               CPU))
    base = jax.tree.map(np.asarray, jM.init_cache(p.jcfg, 3, 16))
    ids = np.array([2, 0], np.int32)
    want = jengine.splice_slot_caches(p.jcfg, jax.tree.map(jnp.asarray, base),
                                      jblocks, jnp.asarray(ids))
    got = engine.splice_slot_caches(p.cfg, convert.cache_from_numpy(base, CPU),
                                    blocks, torch.from_numpy(ids))
    want1 = jengine.write_slot_cache(p.jcfg, jax.tree.map(jnp.asarray, base),
                                     jblocks[0], 1)
    got1 = engine.write_slot_cache(p.cfg, convert.cache_from_numpy(base, CPU),
                                   blocks[0], 1)
    for w, g in ((want, got), (want1, got1)):
        assert set(g) == {"self", "cross"}
        for a, b in zip(jax.tree.leaves(w), _leaves(g)):
            a = np.asarray(a)
            if b.dtype == np.int8:
                assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
def test_launcher_kv_int8_matches_jax_engine(monkeypatch, capsys):
    """The launcher's static path with --kv-int8 --split 0.5: the tokens of
    JAX's int8 ServingEngine run on each group's slice."""
    p = pair_of("llama3.2-1b")
    monkeypatch.setattr(serve.M, "init_params",
                        lambda cfg, seed=0, device=None: p.params)
    n, P, max_new = 6, 8, 5
    ops.reset_launch_counts()
    s = serve.main(["--device", CPU, "--reduced", "--kv-int8", "--requests",
                    str(n), "--prompt-len", str(P), "--max-new", str(max_new),
                    "--split", "0.5"])
    assert sum(ops.launch_counts().values()) == 0
    reqs = request_stream(p.cfg.vocab_size, n=n, mean_prompt=P, seed=0)
    prompts = np.stack([np.pad(r.prompt[:P], (0, max(0, P - len(r.prompt))))
                        for r in reqs]).astype(np.int32)
    n_aux = dict(zip(s["group_names"], s["n_group"]))["auxiliary"]
    want = np.concatenate([
        jengine.ServingEngine(p.jcfg, p.jparams, max_len=P + max_new + 8)
        .generate(prompts[sl], max_new).tokens
        for sl in (slice(0, n_aux), slice(n_aux, n))])     # spoke first
    np.testing.assert_array_equal(s["tokens"], want)
    assert "arch=llama3.2-1b (reduced) kv=int8 topology=pair/2" \
        in capsys.readouterr().out
