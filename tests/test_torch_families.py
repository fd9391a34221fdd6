"""The vlm (internvl2-1b) and audio (seamless-m4t-medium) families in the
port against the JAX package, at reduced size in float32 with the JAX
weights handed over through ``repro_torch.convert``: the configs,
cross-attention, prefill and decode logits with a frontend, ServingEngine
and ContinuousServingEngine streams, the vlm prologue in the prefix cache,
and the launcher's static path."""
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
from repro.serving import prefix_cache as jpc  # noqa: E402
from repro.serving.engine import seed_cache as jseed_cache  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import request_stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import (ContinuousServingEngine,  # noqa: E402
                                        ServeRequest, ServingEngine)
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402

VLM, AUDIO = "internvl2-1b", "seamless-m4t-medium"
FAMILIES = [VLM, AUDIO]
TOL = 1e-4
CPU = "cpu"
# the continuous schedule of tests/test_continuous_batching.py (P=8, five
# requests, max_news [1,6,3,9,4], slots 2, 48 cache rows)
SLOTS, MAX_LEN, PROMPT = 2, 48, 8
COUNT_STATS = ("requests", "total_tokens", "decode_steps", "occupancy",
               "host_syncs", "macro_dispatches", "wave_launches",
               "admission_stalls", "shadow_prefills", "prefix_hits",
               "prefix_blocks_reused", "prefill_flops_avoided",
               "prefill_flops_total")


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


class Pair:
    """One config at reduced size in both packages (``int8``: the int8 KV
    cache), the port's params converted from JAX's."""

    def __init__(self, arch: str, int8: bool = False):
        self.jcfg = jreduced(jget_config(arch))
        self.cfg = reduced(get_config(arch))
        if int8:
            self.jcfg = dataclasses.replace(self.jcfg, kv_quant="int8")
            self.cfg = dataclasses.replace(self.cfg, kv_quant="int8")
        self.jparams = jM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.params = convert.params_from_numpy(
            jax.tree.map(np.asarray, self.jparams), self.cfg, device=CPU)

    def frontend(self, rng, *lead):
        return rng.standard_normal(
            (*lead, self.cfg.frontend_tokens, self.cfg.frontend_dim)
        ).astype(np.float32)


_PAIRS = {}


def pair_of(arch: str, int8: bool = False) -> Pair:
    if (arch, int8) not in _PAIRS:
        _PAIRS[arch, int8] = Pair(arch, int8)
    return _PAIRS[arch, int8]


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_match_field_for_field(arch):
    full, jfull = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(reduced(full)) == dataclasses.asdict(jreduced(jfull))
    assert M.count_params_analytic(full) == jM.count_params_analytic(jfull)
    assert M._kind(full) == jM._kind(jfull)
    p = pair_of(arch)
    assert jax.tree.structure(jax.tree.map(np.asarray, p.jparams)) == \
        jax.tree.structure(jax.tree.map(_np, M.init_params(p.cfg, 0, device=CPU),
                                        is_leaf=torch.is_tensor))


def test_params_check_refuses_a_missing_cross_attention():
    p = pair_of(AUDIO)
    tree = jax.tree.map(np.asarray, p.jparams)
    del tree["blocks"]["xattn"]
    with pytest.raises(ValueError, match="cross-attention"):
        convert.params_from_numpy(tree, p.cfg, device=CPU)
    tree = jax.tree.map(np.asarray, pair_of(VLM).jparams)
    del tree["frontend_proj"]
    with pytest.raises(ValueError, match="frontend_proj missing"):
        convert.params_from_numpy(tree, pair_of(VLM).cfg, device=CPU)


@pytest.mark.parametrize("B", [1, 3])
def test_cross_attention_full_and_decode_match_jax(B, test_seed):
    """The audio decoder's cross-attention (layer 0's weights): mode "full"
    over the encoder rows (no RoPE, no mask) and its K/V, then one decode
    query against those K/V as the cross cache, within 1e-5."""
    p = pair_of(AUDIO)
    rng = np.random.default_rng(test_seed)
    S, F, d = 5, p.cfg.frontend_tokens, p.cfg.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    enc = rng.standard_normal((B, F, d)).astype(np.float32)
    pos, kpos = np.arange(S, dtype=np.int32), np.arange(F, dtype=np.int32)
    jp = jax.tree.map(lambda a: a[0], p.jparams["blocks"]["xattn"])
    tp = {k: v[0] for k, v in p.params["blocks"]["xattn"].items()}
    assert "q_norm" not in tp and set(tp) == set(jp)
    jy, (jk, jv) = jattn.attn_apply(jp, jnp.asarray(x), p.jcfg,
                                    positions=jnp.asarray(pos), mode="full",
                                    kv_x=jnp.asarray(enc),
                                    kv_positions=jnp.asarray(kpos))
    y, (k, v) = attn.attn_apply(tp, torch.from_numpy(x), p.cfg,
                                positions=torch.from_numpy(pos), mode="full",
                                kv_x=torch.from_numpy(enc),
                                kv_positions=torch.from_numpy(kpos))
    for a, b in ((y, jy), (k, jk), (v, jv)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-5)

    x1 = x[:, :1]
    cache = {"k": np.asarray(jk), "v": np.asarray(jv)}
    jy1, _ = jattn.attn_apply(jp, jnp.asarray(x1), p.jcfg,
                              positions=jnp.zeros(1, jnp.int32), mode="decode",
                              cache=jax.tree.map(jnp.asarray, cache),
                              kv_x=jnp.zeros_like(jnp.asarray(x1)))
    tcache = convert.cache_from_numpy(cache, CPU)
    y1, out_cache = attn.attn_apply(tp, torch.from_numpy(x1), p.cfg,
                                    positions=torch.zeros(1, dtype=torch.int32),
                                    mode="decode", cache=tcache, cross=True)
    np.testing.assert_allclose(_np(y1), np.asarray(jy1), rtol=1e-5, atol=1e-5)
    assert out_cache is tcache                 # the cross cache is only read
    np.testing.assert_array_equal(_np(tcache["k"]), cache["k"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_logits_match_jax(arch, test_seed):
    """Prefill with a frontend (the vlm's patch prologue, the audio
    encoder) and a decode step with a scalar and a per-slot index, within
    1e-4 of JAX's logits and caches."""
    p = pair_of(arch)
    rng = np.random.default_rng(test_seed)
    B, P, S = 2, 9, 40
    toks = rng.integers(0, p.cfg.vocab_size, (B, P)).astype(np.int32)
    fe = p.frontend(rng, B)
    jout = jM.forward(p.jparams, p.jcfg, {"tokens": jnp.asarray(toks),
                                          "frontend": jnp.asarray(fe)},
                      mode="prefill")
    out = M.forward(p.params, p.cfg, {"tokens": torch.from_numpy(toks),
                                      "frontend": torch.from_numpy(fe)},
                    mode="prefill")
    np.testing.assert_allclose(_np(out.logits), np.asarray(jout.logits),
                               rtol=TOL, atol=TOL)
    assert set(out.cache) == set(jout.cache)
    for name in out.cache:
        for leaf in ("k", "v"):
            np.testing.assert_allclose(_np(out.cache[name][leaf]),
                                       np.asarray(jout.cache[name][leaf]),
                                       rtol=TOL, atol=TOL)
    rows = P + M.frontend_offset(p.cfg)
    assert out.cache["self"]["k"].shape[2] == rows
    jcache = jseed_cache(p.jcfg, jM.init_cache(p.jcfg, B, S), jout.cache, rows)
    nxt = rng.integers(0, p.cfg.vocab_size, (B, 1)).astype(np.int32)
    for idx in (np.int32(rows), np.array([rows, rows - 3], np.int32)):
        jdec = jM.forward(p.jparams, p.jcfg,
                          {"token": jnp.asarray(nxt), "cache": jcache,
                           "cache_index": jnp.asarray(idx)}, mode="decode")
        cache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), CPU)
        dec = M.forward(p.params, p.cfg,
                        {"token": torch.from_numpy(nxt), "cache": cache,
                         "cache_index": torch.from_numpy(np.asarray(idx))},
                        mode="decode")
        np.testing.assert_allclose(_np(dec.logits), np.asarray(jdec.logits),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_np(dec.cache["self"]["k"]),
                                   np.asarray(jdec.cache["self"]["k"]),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_seeded_cache_matches_jax(arch, test_seed):
    """seed_cache writes the prefill rows (and the whole cross cache) into
    the decode buffers as JAX's does."""
    from repro_torch.serving.engine import seed_cache
    p = pair_of(arch)
    rng = np.random.default_rng(test_seed)
    B, P, S = 2, 6, 32
    toks = rng.integers(0, p.cfg.vocab_size, (B, P)).astype(np.int32)
    fe = p.frontend(rng, B)
    jout = jM.forward(p.jparams, p.jcfg, {"tokens": jnp.asarray(toks),
                                          "frontend": jnp.asarray(fe)},
                      mode="prefill")
    rows = P + M.frontend_offset(p.cfg)
    want = jseed_cache(p.jcfg, jM.init_cache(p.jcfg, B, S), jout.cache, rows)
    big = M.init_cache(p.cfg, B, S, device=CPU)
    got = seed_cache(p.cfg, big, convert.cache_from_numpy(
        jax.tree.map(np.asarray, jout.cache), CPU), rows)
    assert got["self"]["k"] is big["self"]["k"]         # written in place
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(
            jax.tree.map(_np, got, is_leaf=torch.is_tensor))):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-layout", "int8"])
@pytest.mark.parametrize("macro_steps", [0, 8])
@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_matches_jax(arch, macro_steps, int8, test_seed):
    """ServingEngine streams with a frontend identical to JAX's, at K=0 and
    K=8, with the float cache and the int8 one."""
    p = pair_of(arch, int8)
    rng = np.random.default_rng(test_seed + 3)
    B, P, max_new = 3, 7, 11
    prompts = rng.integers(0, p.cfg.vocab_size, (B, P)).astype(np.int32)
    fe = p.frontend(rng, B)
    max_len = P + M.frontend_offset(p.cfg) + max_new + 8
    want = jengine.ServingEngine(p.jcfg, p.jparams, max_len=max_len,
                                 macro_steps=macro_steps).generate(
        prompts, max_new, frontend=fe)
    eng = ServingEngine(p.cfg, p.params, max_len=max_len,
                        macro_steps=macro_steps, device=CPU)
    got = eng.generate(prompts, max_new, frontend=fe)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.host_syncs == want.host_syncs


# ---------------------------------------------------------------------------
def _continuous_reqs(p, seed=7):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, p.cfg.vocab_size, (5, PROMPT)).astype(np.int32)
    fe = p.frontend(rng, 5)
    return [ServeRequest(uid=i, prompt=prompts[i], max_new=m, frontend=fe[i])
            for i, m in enumerate([1, 6, 3, 9, 4])]


def _jreqs(reqs):
    return [jengine.ServeRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                                 frontend=r.frontend) for r in reqs]


def _same(outs, jouts, stats=None, jstats=None):
    assert [o.uid for o in outs] == [o.uid for o in jouts]
    for a, b in zip(outs, jouts):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=f"uid {a.uid}")
        assert (a.admitted_step, a.finished_step) == \
            (b.admitted_step, b.finished_step), a.uid
    if stats is not None:
        for name in COUNT_STATS:
            assert getattr(stats, name) == pytest.approx(getattr(jstats, name)), name


@pytest.mark.parametrize("arch,int8", [(VLM, True), (AUDIO, False), (AUDIO, True)])
def test_fused_equals_per_step_and_jax(arch, int8):
    """tests/test_continuous_batching.py's family case (its
    ("internvl2-1b", True) row, and the audio model): the fused K=4 engine
    and the per-step one give JAX's streams and counts."""
    p = pair_of(arch, int8)
    reqs = _continuous_reqs(p)
    jper = jengine.ContinuousServingEngine(p.jcfg, p.jparams, slots=SLOTS,
                                           max_len=MAX_LEN, macro_steps=0)
    jfused = jengine.ContinuousServingEngine(p.jcfg, p.jparams, slots=SLOTS,
                                             max_len=MAX_LEN, macro_steps=4,
                                             share_from=jper)
    jref, jref_stats = jper.run(_jreqs(reqs))
    jouts, jstats = jfused.run(_jreqs(reqs))
    per = ContinuousServingEngine(p.cfg, p.params, slots=SLOTS, max_len=MAX_LEN,
                                  macro_steps=0, device=CPU)
    fused = ContinuousServingEngine(p.cfg, p.params, slots=SLOTS,
                                    max_len=MAX_LEN, macro_steps=4, device=CPU)
    ref, ref_stats = per.run(reqs)
    outs, stats = fused.run(reqs)
    _same(ref, jref, ref_stats, jref_stats)
    _same(outs, jouts, stats, jstats)
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert stats.host_syncs < ref_stats.host_syncs


@pytest.mark.parametrize("mode", ["boundary", "overlapped"])
def test_audio_continuous_modes_match_jax(mode):
    """seamless through the continuous engine's other schedules: its cross
    cache is written whole into each slot at admission."""
    p = pair_of(AUDIO)
    kw = dict(macro_steps=4, overlap_admission=mode == "overlapped")
    reqs = _continuous_reqs(p, seed=8)
    jouts, jstats = jengine.ContinuousServingEngine(
        p.jcfg, p.jparams, slots=SLOTS, max_len=MAX_LEN, **kw).run(_jreqs(reqs))
    outs, stats = ContinuousServingEngine(p.cfg, p.params, slots=SLOTS,
                                          max_len=MAX_LEN, device=CPU,
                                          **kw).run(reqs)
    _same(outs, jouts, stats, jstats)


def test_vlm_max_len_counts_the_prologue():
    p = pair_of(VLM)
    reqs = _continuous_reqs(p)
    eng = ContinuousServingEngine(p.cfg, p.params, slots=SLOTS,
                                  max_len=PROMPT + 9, device=CPU)
    with pytest.raises(ValueError, match="max_len too small"):
        eng.run(reqs)


# the shared-prefix workload of tests/test_prefix_serving.py (16 of 20
# prompt tokens common, one image for every request, an exact duplicate)
PC_SLOTS, PC_MAX_LEN, PC_PROMPT, PC_SHARED = 2, 64, 20, 16
PC_MAX_NEWS = [3, 5, 2, 4, 6, 4]


def _prefix_reqs(p):
    rng = np.random.default_rng(11)
    shared = rng.integers(0, p.cfg.vocab_size, (PC_SHARED,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, p.cfg.vocab_size, (PC_PROMPT - PC_SHARED,)).astype(np.int32)])
        for _ in range(len(PC_MAX_NEWS) - 1)]
    prompts.append(prompts[0].copy())
    fe = p.frontend(rng)
    return [ServeRequest(uid=i, prompt=prompts[i], max_new=m, frontend=fe)
            for i, m in enumerate(PC_MAX_NEWS)]


def test_vlm_cached_streams_match_jax():
    """tests/test_prefix_serving.py's ("internvl2-1b", True) row: cached
    streams (the prologue root plus token blocks, resumed at row F + q)
    equal the uncached per-step reference and JAX's, with JAX's hits and
    FLOPs; a second pass full-hits every request."""
    p = pair_of(VLM, True)
    reqs = _prefix_reqs(p)
    jbase = jengine.ContinuousServingEngine(p.jcfg, p.jparams, slots=PC_SLOTS,
                                            max_len=PC_MAX_LEN, macro_steps=0)
    jref, _ = jbase.run(_jreqs(reqs))
    jc = jpc.PrefixCache(p.jcfg, block_size=8, budget_blocks=64)
    tc = PrefixCache(p.cfg, block_size=8, budget_blocks=64, device=CPU)
    je = jengine.ContinuousServingEngine(p.jcfg, p.jparams, slots=PC_SLOTS,
                                         max_len=PC_MAX_LEN, macro_steps=4,
                                         prefix_cache=jc, share_from=jbase)
    te = ContinuousServingEngine(p.cfg, p.params, slots=PC_SLOTS,
                                 max_len=PC_MAX_LEN, macro_steps=4,
                                 prefix_cache=tc, device=CPU)
    for rnd in range(2):
        jouts, jstats = je.run(_jreqs(reqs))
        outs, stats = te.run(reqs)
        for a, b, c in zip(jref, jouts, outs):
            np.testing.assert_array_equal(a.tokens, c.tokens)
            np.testing.assert_array_equal(b.tokens, c.tokens)
        for name in COUNT_STATS:
            assert getattr(stats, name) == pytest.approx(getattr(jstats, name)), name
        assert tc.stats() == jc.stats()
        tc.check_invariants()
        assert stats.prefix_hits == (len(reqs) - 1 if rnd == 0 else len(reqs))


def _synth(toks, F):
    """A B=1 vlm prefill cache of F prologue rows + the tokens' rows; row i
    encodes the running sum of (zeros for the prologue, then tokens)."""
    vals = np.concatenate([np.zeros(F, np.float32), np.asarray(toks, np.float32)])
    pre = np.cumsum(vals)[None, None, :, None, None]
    grid = (np.arange(2, dtype=np.float32)[:, None, None, None, None] * 1e3
            + np.arange(4, dtype=np.float32)[None, None, None, None, :] * .01)
    k = np.broadcast_to(pre + grid, (2, 1, len(vals), 2, 4)).copy()
    return {"self": {"k": k, "v": k + 0.5}}, np.asarray([float(vals.sum())],
                                                         np.float32)


def test_vlm_prefix_cache_roots_keyed_by_frontend():
    """tests/test_prefix_cache.py's vlm case and more, operation for
    operation against JAX's cache: roots keyed by the image, the prologue
    root's payload, full hits over F + tokens rows, a partial hit resuming
    at F + q, a prologue-only resume, pins and eviction."""
    cfg, jcfg = reduced(get_config(VLM)), jreduced(jget_config(VLM))
    F = cfg.frontend_tokens
    tc = PrefixCache(cfg, block_size=4, budget_blocks=5, device=CPU)
    jc = jpc.PrefixCache(jcfg, block_size=4, budget_blocks=5)
    fe_a, fe_b = np.ones((F, 4), np.float32), np.zeros((F, 4), np.float32)

    def insert(toks, fe):
        cache, logits = _synth(toks, F)
        jc.insert(toks, jnp.asarray(logits), jax.tree.map(jnp.asarray, cache),
                  frontend=fe)
        tc.insert(toks, torch.from_numpy(logits),
                  convert.cache_from_numpy(cache, CPU), frontend=fe)
        assert tc.stats() == jc.stats()

    def match(toks, fe):
        a, b = jc.match(toks, frontend=fe), tc.match(toks, frontend=fe)
        assert (a.q_rows, a.rows_total, a.blocks, a.hit, len(a.pins)) == \
            (b.q_rows, b.rows_total, b.blocks, b.hit, len(b.pins))
        assert (a.flops_avoided, a.flops_total) == (b.flops_avoided, b.flops_total)
        for x, y in ((a.full, b.full), (a.prefix, b.prefix)):
            assert (x is None) == (y is None)
            if x is not None:
                for u, v in zip(jax.tree.leaves(x), jax.tree.leaves(
                        jax.tree.map(_np, y, is_leaf=torch.is_tensor))):
                    np.testing.assert_array_equal(np.asarray(u), v)
        assert tc.stats() == jc.stats()
        return a, b

    toks = np.arange(1, 9, dtype=np.int32)
    insert(toks, fe_a)
    assert not match(toks, fe_b)[1].hit             # another image: a miss
    a, b = match(toks, fe_a)
    assert b.full is not None and b.q_rows == F + len(toks)
    other = toks.copy()
    other[-1] = 99                                  # shares block 0
    a, b = match(other, fe_a)
    assert b.prefix is not None and b.q_rows == F + 4
    jc.release(a)
    tc.release(b)
    fresh = toks + 50                               # shares only the prologue
    a, b = match(fresh, fe_a)
    assert b.q_rows == F and b.blocks == 1
    jc.release(a)
    tc.release(b)
    for i in range(3):                              # evict past the budget
        insert(toks + 100 * (i + 1), fe_b if i % 2 else fe_a)
    tc.check_invariants()
    jc.check_invariants()
    assert tc.stats() == jc.stats()


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_static_matches_jax_engine(arch, monkeypatch, capsys):
    """The launcher's static path (--split 0.5) with the request stream's
    frontend: its tokens equal JAX's ServingEngine run on each group's
    slice, with the cache sized for prompt + the vlm's prologue + max_new
    + 8 rows."""
    p = pair_of(arch)
    monkeypatch.setattr(serve.M, "init_params",
                        lambda cfg, seed=0, device=None: p.params)
    n, P, max_new = 6, 8, 5
    ops.reset_launch_counts()
    s = serve.main(["--device", CPU, "--reduced", "--arch", arch,
                    "--requests", str(n), "--prompt-len", str(P),
                    "--max-new", str(max_new), "--split", "0.5"])
    assert ops.launch_counts() == {"decode_attention": 0, "masked_compact": 0,
                                   "grouped_ffn": 0, "ssm_scan": 0,
                                   "ssm_scan_bwd": 0, "prefill_attention": 0,
                                   "mla_decode_attention": 0,
                                   "grouped_ffn_sorted": 0}
    reqs = request_stream(p.cfg.vocab_size, n=n, mean_prompt=P, seed=0,
                          frontend_tokens=p.cfg.frontend_tokens,
                          frontend_dim=p.cfg.frontend_dim)
    prompts = np.stack([np.pad(r.prompt[:P], (0, max(0, P - len(r.prompt))))
                        for r in reqs]).astype(np.int32)
    fe = np.stack([r.frontend for r in reqs])
    groups = dict(zip(s["group_names"], s["n_group"]))
    n_aux = groups["auxiliary"]
    assert 0 < n_aux < n
    max_len = P + M.frontend_offset(p.cfg) + max_new + 8
    want = np.concatenate([
        jengine.ServingEngine(p.jcfg, p.jparams, max_len=max_len).generate(
            prompts[sl], max_new, frontend=fe[sl]).tokens
        for sl in (slice(0, n_aux), slice(n_aux, n))])     # spoke first
    np.testing.assert_array_equal(s["tokens"], want)
    assert f"arch={arch} (reduced) topology=pair/2" in capsys.readouterr().out
