"""The port's prefix cache, KV hop, prefix-resumed prefill and
disaggregated prefill workers against the JAX package's, at reduced size in
float32: trie hits, ``stats()`` and invariants over the JAX suite's
insert/match/release/evict sequences; the lossless hop bit for bit and the
lossy one index for index; served streams and byte counters of the shared
prefix workload in every cache family; the prefill-fault schedules; pool
affinity; the §VI pixel accounting; and that no stored block is ever
written by later serving."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as JC  # noqa: E402
import repro_torch.core as C  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.core import masking as jmasking  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import prefill as jprefill  # noqa: E402
from repro.serving import prefix_cache as jpc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core import masking  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import prefix_cache as pc_mod  # noqa: E402
from repro_torch.serving.engine import (ContinuousServingEngine,  # noqa: E402
                                        ServeRequest)
from repro_torch.serving.prefill import (PrefillWorker,  # noqa: E402
                                         PrefillWorkerError,
                                         PrefillWorkerPool,
                                         PrefillWorkerTimeout)
from repro_torch.serving.prefix_cache import (PrefixCache,  # noqa: E402
                                              compact_kv_hop, prefill_flops,
                                              restore_kv_hop)

CPU = "cpu"
L, HKV, DH = 2, 2, 4


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


# ---------------------------------------------------------------------------
# synthetic caches: row i is a function of tokens[:i+1] (causal structure)
# ---------------------------------------------------------------------------
def synth(toks):
    toks = np.asarray(toks, np.float32)
    pre = np.cumsum(toks)[None, None, :, None, None]
    grid = (np.arange(L, dtype=np.float32)[:, None, None, None, None] * 1e3
            + np.arange(HKV, dtype=np.float32)[None, None, None, :, None] * 10
            + np.arange(DH, dtype=np.float32)[None, None, None, None, :] * .01)
    k = pre + grid
    return {"self": {"k": k, "v": k + 0.5}}, np.asarray([float(np.sum(toks))],
                                                         np.float32)


class Pair:
    """A JAX and a port PrefixCache driven through the same operations;
    every result is compared as it comes."""

    def __init__(self, arch="llama3.2-1b", **kw):
        self.j = jpc.PrefixCache(jreduced(jget_config(arch)), **kw)
        self.t = PrefixCache(reduced(get_config(arch)), device=CPU, **kw)

    def insert(self, toks, cache=None):
        cache, logits = (cache, np.ones(1, np.float32)) if cache is not None \
            else synth(toks)
        self.j.insert(toks, jnp.asarray(logits), jax.tree.map(jnp.asarray, cache))
        self.t.insert(toks, torch.from_numpy(logits),
                      convert.cache_from_numpy(cache, CPU))
        self.check()

    def match(self, toks):
        a, b = self.j.match(toks), self.t.match(toks)
        assert (a.q_rows, a.rows_total, a.blocks, a.hit) == \
            (b.q_rows, b.rows_total, b.blocks, b.hit)
        assert (a.flops_avoided, a.flops_total) == (b.flops_avoided, b.flops_total)
        assert (a.full is None) == (b.full is None)
        assert (a.prefix is None) == (b.prefix is None)
        for x, y in ((a.full, b.full), (a.prefix, b.prefix)):
            if x is not None:
                for u, v in zip(jax.tree.leaves(x), jax.tree.leaves(
                        jax.tree.map(_np, y, is_leaf=torch.is_tensor))):
                    np.testing.assert_array_equal(np.asarray(u), v)
        assert len(a.pins) == len(b.pins)
        self.check()
        return a, b

    def release(self, pair):
        self.j.release(pair[0])
        self.t.release(pair[1])
        self.check()

    def check(self):
        assert self.j.stats() == self.t.stats()
        self.j.check_invariants()
        self.t.check_invariants()
        refs = lambda c: sorted(n.refs for n in c._payload_nodes)  # noqa: E731
        assert refs(self.j) == refs(self.t)


# ---------------------------------------------------------------------------
def test_prefill_flops_match_jax():
    for arch in ("llama3.2-1b", "moonshot-v1-16b-a3b", "falcon-mamba-7b",
                 "zamba2-2.7b", "olmo-1b", "nemotron-4-15b"):
        for rows, cached in ((32, 0), (32, 24), (200, 64), (7, 7)):
            assert prefill_flops(get_config(arch), rows, cached) == \
                jpc.prefill_flops(jget_config(arch), rows, cached)


def test_full_and_partial_hits_match_jax():
    p = Pair(block_size=8, budget_blocks=64)
    a = np.arange(1, 21, dtype=np.int32)      # 2 blocks + a tail of 4
    p.insert(a)
    p.match(a)                                # full hit
    b = a.copy()
    b[16:] = [99, 98, 97, 96]                 # shares blocks 0..1
    hit = p.match(b)
    assert hit[1].q_rows == 16 and hit[1].blocks == 2
    assert all(n.refs == 1 for n in hit[1].pins)
    p.release(hit)
    p.release(hit)                            # a second release is a no-op
    assert all(n.refs == 0 for n in p.t._payload_nodes)


def test_divergent_tokens_and_copies_match_jax():
    p = Pair(block_size=4, budget_blocks=64)
    a = np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32)
    b = np.array([1, 2, 3, 4, 9, 9, 9, 9], np.int32)
    p.insert(a)
    p.insert(b)
    assert p.t.n_blocks == 5
    for toks in (a, b):
        _, hit = p.match(toks)
        np.testing.assert_array_equal(hit.full[1]["self"]["k"].numpy(),
                                      synth(toks)[0]["self"]["k"])
    # copies, not views: writing the inserted cache changes nothing stored
    cache = convert.cache_from_numpy(synth(a[::-1])[0], CPU)
    p.t.insert(a[::-1].copy(), torch.ones(1), cache)
    cache["self"]["k"].fill_(-1.0)
    _, full = p.t.match(a[::-1].copy()).full
    np.testing.assert_array_equal(full["self"]["k"].numpy(),
                                  synth(a[::-1])[0]["self"]["k"])


def test_eviction_and_pins_match_jax():
    p = Pair(block_size=4, budget_blocks=3)
    prompts = [np.arange(i, i + 8, dtype=np.int32) for i in range(0, 50, 10)]
    for q in prompts:
        p.insert(q)
    assert p.t.evictions > 0
    probe = prompts[-1].copy()
    probe[4:] = 77
    hit = p.match(probe)
    assert hit[1].pins
    for q in prompts[:3]:
        p.insert(q)
    p.release(hit)
    assert p.t.n_blocks <= 3


def test_nondense_exact_match_only():
    cfg = reduced(get_config("falcon-mamba-7b"))
    assert M._kind(cfg) == "ssm"
    p = Pair("falcon-mamba-7b", block_size=8, budget_blocks=8)
    toks = np.arange(1, 13, dtype=np.int32)
    state = (np.arange(6.0, dtype=np.float32).reshape(2, 3),
             np.ones((2, 2), np.float32))
    p.insert(toks, cache=state)
    probe = toks.copy()
    probe[-1] = 999
    assert not p.match(probe)[1].hit
    _, hit = p.match(toks)
    np.testing.assert_array_equal(hit.full[1][0].numpy(), state[0])


@pytest.mark.parametrize("seed", range(8))
def test_interleaved_schedules_match_jax(seed):
    """tests/test_prefix_cache.py's random insert/match/release schedules."""
    rng = np.random.default_rng(seed)
    p = Pair(block_size=4, budget_blocks=int(rng.integers(2, 7)))
    outstanding = []
    for _ in range(30):
        toks = rng.choice([1, 2, 3], size=int(rng.integers(4, 13))).astype(np.int32)
        op = rng.choice(["insert", "match", "release"])
        if op == "insert":
            p.insert(toks)
        elif op == "match":
            hit = p.match(toks)
            if hit[1].prefix is not None:
                outstanding.append(hit)
        elif outstanding:
            p.release(outstanding.pop(int(rng.integers(len(outstanding)))))
    for hit in outstanding:
        p.release(hit)
    assert all(n.refs == 0 for n in p.t._payload_nodes)
    assert p.t.n_blocks <= p.t.budget_blocks


# ---------------------------------------------------------------------------
# KV hop
# ---------------------------------------------------------------------------
def _hop_case(S, q, hkv=2, dh=4, dtype=np.float32, seed=None):
    rng = np.random.default_rng(S * 100 + q if seed is None else seed)
    k = rng.standard_normal((L, 1, S, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((L, 1, S, hkv, dh)).astype(np.float32)
    jcache = {"self": {"k": jnp.asarray(k, dtype), "v": jnp.asarray(v, dtype)}}
    cache = {"self": {n: torch.from_numpy(np.array(a, np.float32))
                      for n, a in jcache["self"].items()}}
    if dtype != np.float32:
        cache = {"self": {n: t.to(torch.bfloat16) for n, t in cache["self"].items()}}
    return jcache, cache


@pytest.mark.parametrize("S,q,hkv,dh,dtype", [
    (12, 5, 2, 4, np.float32), (16, 8, 2, 4, np.float32),
    (10, 9, 2, 4, np.float32), (10, 1, 2, 4, np.float32),
    (12, 4, 2, 80, np.float32), (140, 130, 1, 4, np.float32),
    (12, 6, 2, 4, jnp.bfloat16)])
def test_kv_hop_lossless_matches_jax(S, q, hkv, dh, dtype):
    """Lossless: the restore is the port's own cache bit for bit, within
    1e-5 of JAX's restore (JAX's Pallas compaction in interpret mode), and
    the wire bytes equal JAX's."""
    jcache, cache = _hop_case(S, q, hkv, dh, dtype)
    prefix = {"self": {n: t[:, :, :q] for n, t in cache["self"].items()}}
    packed, wire = compact_kv_hop(cache, q)
    restored = restore_kv_hop(packed, prefix)
    jpacked, jwire = jpc.compact_kv_hop(jcache, q)
    jrestored = jpc.restore_kv_hop(
        jpacked, jax.tree.map(lambda a: a[:, :, :q], jcache))
    assert wire == jwire and packed["lossless"]
    for n in ("k", "v"):
        assert torch.equal(restored["self"][n], cache["self"][n])
        np.testing.assert_allclose(
            restored["self"][n].float().numpy(),
            np.asarray(jrestored["self"][n], np.float32), atol=1e-5)


def test_kv_hop_strided_tail_and_no_tail(monkeypatch):
    """The tail of a [L,1,S,Hkv,dh] cache is a strided view; the hop hands
    the compaction a contiguous copy (the CUDA kernel takes no other) and
    still restores bit for bit.  A hop with no tail raises."""
    _, cache = _hop_case(20, 6)
    seen = []
    compact = pc_mod.ops.masked_compact

    def spy(tokens, mask, capacity):
        seen.append(tokens.is_contiguous())
        return compact(tokens, mask, capacity)

    monkeypatch.setattr(pc_mod.ops, "masked_compact", spy)
    assert not cache["self"]["k"][:, 0, 6:].is_contiguous()
    packed, _ = compact_kv_hop(cache, 6)
    assert seen == [True, True]
    prefix = {"self": {n: t[:, :, :6] for n, t in cache["self"].items()}}
    restored = restore_kv_hop(packed, prefix)
    for n in ("k", "v"):
        assert torch.equal(restored["self"][n], cache["self"][n])
    with pytest.raises(ValueError):
        compact_kv_hop(cache, 20)


@pytest.mark.parametrize("keep_rate", [0.5, 0.72])
def test_kv_hop_lossy_matches_jax(keep_rate):
    """Lossy: the kept row indices equal JAX's (except rows whose K-norm
    score ties within 1e-6 at the threshold), dropped rows come back zero
    and the wire bytes equal JAX's."""
    S, q = 40, 4
    jcache, cache = _hop_case(S, q, seed=3)
    packed, wire = compact_kv_hop(cache, q, keep_rate=keep_rate)
    jpacked, jwire = jpc.compact_kv_hop(jcache, q, keep_rate=keep_rate)
    assert wire == jwire and not packed["lossless"]
    scores = np.linalg.norm(np.asarray(jcache["self"]["k"])[:, 0, q:]
                            .reshape(L, S - q, -1), axis=-1)
    k = max(1, round(keep_rate * (S - q)))
    thresh = np.sort(scores, axis=-1)[:, S - q - k][:, None]
    tie = np.abs(scores - thresh) < 1e-6
    for n in ("k", "v"):
        idx = packed[n][1].numpy()
        jidx = np.asarray(jpacked[n][1])
        for layer in range(L):
            got = set(idx[layer][idx[layer] >= 0])
            want = set(jidx[layer][jidx[layer] >= 0])
            assert got ^ want <= set(np.nonzero(tie[layer])[0])
    prefix = {"self": {n: t[:, :, :q] for n, t in cache["self"].items()}}
    restored = restore_kv_hop(packed, prefix)["self"]["k"].numpy()
    ref = cache["self"]["k"].numpy()
    np.testing.assert_array_equal(restored[:, :, :q], ref[:, :, :q])
    tail_got = restored[0, 0, q:].reshape(S - q, -1)
    tail_ref = ref[0, 0, q:].reshape(S - q, -1)
    kept = [i for i in range(S - q) if np.array_equal(tail_got[i], tail_ref[i])]
    assert len(kept) == k
    assert all(not tail_got[i].any() for i in range(S - q) if i not in kept)


def test_compression_pieces_match_jax():
    rng = np.random.default_rng(1)
    scores = rng.standard_normal((2, 10)).astype(np.float32)
    for rate in (1e-9, 0.34, 1.0):
        np.testing.assert_array_equal(
            masking.make_mask(torch.from_numpy(scores), rate).numpy(),
            np.asarray(jmasking.make_mask(jnp.asarray(scores), rate)))
    mask = np.zeros((3, 16), bool)
    a = masking.compression_report(torch.from_numpy(mask), 4, 8)
    b = jmasking.compression_report(jnp.asarray(mask), 4, 8)
    assert (a.kept_tokens, a.bytes_before, a.bytes_after) == \
        (b.kept_tokens, b.bytes_before, b.bytes_after)


@pytest.mark.parametrize("fractions", [[0.1, 0.3, 0.25], [0.0], [1.0, 0.5]])
def test_image_mask_savings_matches_jax(fractions):
    frac = np.asarray(fractions)
    assert C.image_mask_savings(frac) == jmasking.image_mask_savings(frac)
    assert C.image_mask_savings(frac, detector_ms_per_image=4.0) == \
        jmasking.image_mask_savings(frac, detector_ms_per_image=4.0)


# ---------------------------------------------------------------------------
# prefix-resumed prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmo-1b", "nemotron-4-15b"])
def test_resume_prefill_matches_jax(arch, test_seed):
    """forward(batch["prefix"]) against JAX's: last logits and the
    full-length cache within 1e-4, the cache laid out like a cold
    prefill's."""
    jcfg = jreduced(jget_config(arch))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                       device=CPU)
    rng = np.random.default_rng(test_seed)
    toks = rng.integers(0, cfg.vocab_size, (1, 20)).astype(np.int32)
    prefill = jax.jit(lambda p, b: (lambda o: (o.logits, o.cache))(
        jM.forward(p, jcfg, b, mode="prefill")))
    cold = prefill(jparams, {"tokens": toks})[1]
    for q in (8, 19):
        jpre = jax.tree.map(lambda a: a[:, :, :q], cold)
        want_logits, want_cache = prefill(jparams, {"tokens": toks, "prefix": jpre})
        got = M.forward(params, cfg, {"tokens": torch.from_numpy(toks),
                                      "prefix": convert.cache_from_numpy(
                                          jax.tree.map(np.asarray, jpre), CPU)},
                        mode="prefill")
        np.testing.assert_allclose(got.logits.numpy(), np.asarray(want_logits),
                                   atol=1e-4, rtol=0)
        for n in ("k", "v"):
            assert got.cache["self"][n].shape == want_cache["self"][n].shape
            np.testing.assert_allclose(got.cache["self"][n].numpy(),
                                       np.asarray(want_cache["self"][n]),
                                       atol=1e-4, rtol=0)


def test_resume_prefill_refuses_recurrent_stacks():
    cfg = reduced(get_config("falcon-mamba-7b"))
    params = M.init_params(cfg, 0, device=CPU)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="dense"):
        M.forward(params, cfg, {"tokens": toks, "prefix": {"self": {
            "k": torch.zeros(1, 1, 4, 1, 1), "v": torch.zeros(1, 1, 4, 1, 1)}}},
            mode="prefill")


# ---------------------------------------------------------------------------
# serving with the cache, disaggregated prefill, faults
# ---------------------------------------------------------------------------
SLOTS, MAX_LEN, PROMPT, SHARED = 2, 64, 20, 16
MAX_NEWS = [3, 5, 2, 4, 6, 4]
STATS = ("requests", "total_tokens", "decode_steps", "host_syncs",
         "macro_dispatches", "admission_stalls", "shadow_prefills",
         "prefill_offloaded", "prefill_fallbacks", "prefix_hits",
         "prefix_blocks_reused", "prefill_flops_avoided",
         "prefill_flops_total", "kv_hop_bytes_raw", "kv_hop_bytes_wire")


class Served:
    """tests/test_prefix_serving.py's shared-prefix workload (16 of 20
    prompt tokens common, one exact duplicate) in both packages."""

    def __init__(self, arch):
        self.jcfg = jreduced(jget_config(arch))
        self.jparams = jM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.cfg = reduced(get_config(arch))
        self.params = convert.params_from_numpy(
            jax.tree.map(np.asarray, self.jparams), self.cfg, device=CPU)
        rng = np.random.default_rng(11)
        shared = rng.integers(0, self.cfg.vocab_size, (SHARED,)).astype(np.int32)
        prompts = [np.concatenate([shared, rng.integers(
            0, self.cfg.vocab_size, (PROMPT - SHARED,)).astype(np.int32)])
            for _ in range(len(MAX_NEWS) - 1)]
        prompts.append(prompts[0].copy())
        self.reqs = [ServeRequest(uid=i, prompt=prompts[i], max_new=m)
                     for i, m in enumerate(MAX_NEWS)]
        self.jreqs = [jengine.ServeRequest(uid=r.uid, prompt=r.prompt,
                                           max_new=r.max_new) for r in self.reqs]
        self.jbase = jengine.ContinuousServingEngine(
            self.jcfg, self.jparams, slots=SLOTS, max_len=MAX_LEN, macro_steps=0)
        self.ref, _ = self.jbase.run(self.jreqs)
        self.jworker = jprefill.PrefillWorker(self.jcfg, self.jparams,
                                              device=jax.devices()[0],
                                              link=JC.ICI_LINK)

    def jworker_like(self, **kw):
        return jprefill.PrefillWorker(self.jcfg, self.jparams,
                                      device=jax.devices()[0], link=JC.ICI_LINK,
                                      share_from=self.jworker, **kw)

    def both(self, *, cache=False, jworker=None, worker=None, macro_steps=4):
        jc = jpc.PrefixCache(self.jcfg, block_size=8, budget_blocks=64) \
            if cache else None
        tc = PrefixCache(self.cfg, block_size=8, budget_blocks=64, device=CPU) \
            if cache else None
        je = jengine.ContinuousServingEngine(
            self.jcfg, self.jparams, slots=SLOTS, max_len=MAX_LEN,
            macro_steps=macro_steps, prefix_cache=jc, prefill_worker=jworker,
            share_from=self.jbase)
        te = ContinuousServingEngine(
            self.cfg, self.params, slots=SLOTS, max_len=MAX_LEN,
            macro_steps=macro_steps, prefix_cache=tc, prefill_worker=worker,
            device=CPU)
        return je, te, jc, tc

    def compare(self, je, te, jc=None, tc=None):
        jouts, jstats = je.run(self.jreqs)
        outs, stats = te.run(self.reqs)
        for a, b, c in zip(self.ref, jouts, outs):
            np.testing.assert_array_equal(a.tokens, c.tokens)
            np.testing.assert_array_equal(b.tokens, c.tokens)
        for name in STATS:
            assert getattr(stats, name) == pytest.approx(getattr(jstats, name)), name
        assert stats.t_kv_transfer_s == pytest.approx(jstats.t_kv_transfer_s,
                                                      rel=1e-6)
        if tc is not None:
            assert tc.stats() == jc.stats()
            tc.check_invariants()
        return stats


_SERVED = {}


def _served(arch) -> Served:
    if arch not in _SERVED:
        _SERVED[arch] = Served(arch)
    return _SERVED[arch]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "moonshot-v1-16b-a3b",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
def test_cached_streams_match_jax(arch):
    """Cached streams equal the uncached per-step reference and JAX's, with
    JAX's hits and FLOPs; a second pass full-hits every request."""
    s = _served(arch)
    je, te, jc, tc = s.both(cache=True)
    stats = s.compare(je, te, jc, tc)
    assert stats.prefix_hits >= 1 and stats.prefill_flops_avoided > 0
    if M._kind(s.cfg) == "dense":
        assert stats.prefix_hits >= len(s.reqs) - 1
    stats2 = s.compare(je, te, jc, tc)
    assert stats2.prefix_hits == len(s.reqs)


def test_disaggregated_hops_and_lossy_match_jax():
    """Remote admission with the hub cache: hits resume on the prefill
    group and only compacted tails cross; the lossy knob shrinks the wire
    bytes further, as much as in JAX."""
    s = _served("llama3.2-1b")
    wires = {}
    for keep in (None, 0.5):
        w = PrefillWorker(s.cfg, s.params, device=CPU, link=C.ICI_LINK,
                          kv_keep_rate=keep)
        assert w.params["embed"]["table"] is s.params["embed"]["table"]
        je, te, jc, tc = s.both(cache=True, worker=w,
                                jworker=s.jworker_like(kv_keep_rate=keep))
        if keep is None:
            stats = s.compare(je, te, jc, tc)
        else:                    # lossy streams may leave the reference
            jstats, stats = je.run(s.jreqs)[1], te.run(s.reqs)[1]
            for name in ("kv_hop_bytes_raw", "kv_hop_bytes_wire",
                         "prefill_offloaded", "prefix_hits"):
                assert getattr(stats, name) == getattr(jstats, name), name
        assert 0 < stats.kv_hop_bytes_wire < stats.kv_hop_bytes_raw
        assert w.kv_bytes_wire == pytest.approx(stats.kv_hop_bytes_wire)
        assert stats.prefill_offloaded < len(s.reqs)
        wires[keep] = stats
    assert wires[0.5].kv_hop_bytes_wire < wires[None].kv_hop_bytes_wire
    assert wires[0.5].kv_hop_bytes_raw == wires[None].kv_hop_bytes_raw


def test_pool_failover_and_affinity_match_jax():
    s = _served("llama3.2-1b")
    pool = PrefillWorkerPool(s.cfg, s.params, size=2, device=CPU,
                             link=C.ICI_LINK)
    pool.inject_fault("dispatch", after=0, worker=0)
    jpool = jprefill.PrefillWorkerPool(s.jcfg, s.jparams, size=2,
                                       device=jax.devices()[0], link=JC.ICI_LINK)
    jpool.inject_fault("dispatch", after=0, worker=0)
    je, te, _, _ = s.both(jworker=jpool, worker=pool)
    stats = s.compare(je, te)
    assert pool.healthy and not pool.workers[0].healthy
    assert stats.prefill_fallbacks == 0
    assert [w.dispatched for w in pool.workers] == \
        [w.dispatched for w in jpool.workers]
    for r in s.reqs:
        batch = {"tokens": np.asarray(r.prompt)[None]}
        assert PrefillWorkerPool._batch_key(batch) == \
            jprefill.PrefillWorkerPool._batch_key(batch)
    # same content -> same member; whole-pool death and revival
    pool = PrefillWorkerPool(s.cfg, s.params, size=3, device=CPU)
    batch = {"tokens": np.asarray(s.reqs[0].prompt)[None]}
    l1, c1 = pool.dispatch(batch)
    owner = pool._inflight[id(l1)]
    l2, c2 = pool.dispatch(batch)
    assert pool._inflight[id(l2)] is owner
    pool.fetch(l1, c1)
    pool.fetch(l2, c2)
    with pytest.raises(PrefillWorkerError):
        pool.fetch(l1, c1)
    pool.kill()
    with pytest.raises(PrefillWorkerError):
        pool.dispatch(batch)
    pool.restore()
    pool.fetch(*pool.dispatch(batch))


FAULTS = [("healthy", None, None, False), ("dispatch", 0, None, False),
          ("dispatch", 2, None, False), ("dispatch", 5, None, False),
          ("fetch", 1, None, False), ("fetch", 3, None, False),
          ("fetch", 0, None, True), ("killed", None, None, False),
          ("dispatch", 1, 1, False), ("dispatch", 2, 2, False)]


@pytest.mark.parametrize("kind,after,k,timeout", FAULTS)
def test_prefill_faults_match_jax(kind, after, k, timeout):
    """tests/test_prefill_faults.py's schedules (a churny 8-request stream
    over a dying prefill group): the same streams as the per-step reference
    and JAX, the same offloaded and fallback counts."""
    s = _faults()
    w = PrefillWorker(s.cfg, s.params, device=CPU, link=C.ICI_LINK)
    jw = s.jworker_like()
    for worker in (w, jw):
        if kind == "killed":
            worker.kill()
        elif kind != "healthy":
            worker.inject_fault(kind, after=after, timeout=timeout)
    je, te, _, _ = s.both(jworker=jw, worker=w, macro_steps=k or 4)
    stats = s.compare(je, te)
    assert w.healthy == jw.healthy == (kind == "healthy")
    if kind == "healthy":
        assert stats.prefill_offloaded == len(s.reqs) and stats.t_kv_transfer_s > 0
    elif kind == "killed":
        assert stats.prefill_offloaded == stats.prefill_fallbacks == 0
    else:
        assert stats.prefill_fallbacks >= 1


def test_dead_worker_raises_for_direct_callers():
    s = _faults()
    w = PrefillWorker(s.cfg, s.params, device=CPU)
    w.kill()
    with pytest.raises(PrefillWorkerError):
        w.dispatch({"tokens": np.ones((1, 8), np.int32)})
    with pytest.raises(PrefillWorkerError):
        w.fetch(torch.zeros(1, 4))
    w2 = PrefillWorker(s.cfg, s.params, device=CPU)
    w2.inject_fault("dispatch", after=0, timeout=True)
    with pytest.raises(PrefillWorkerTimeout):
        w2.dispatch({"tokens": np.ones((1, 8), np.int32)})
    with pytest.raises(ValueError):
        w2.inject_fault("nothing")


class _Faults(Served):
    """The fault tier's stream: 8 requests of 8 tokens, singles and mixed
    lengths."""

    def __init__(self):
        super().__init__("llama3.2-1b")
        rng = np.random.default_rng(0)
        max_news = [1, 6, 3, 1, 7, 4, 2, 5]
        prompts = rng.integers(0, self.cfg.vocab_size,
                               (len(max_news), 8)).astype(np.int32)
        self.reqs = [ServeRequest(uid=i, prompt=prompts[i], max_new=m)
                     for i, m in enumerate(max_news)]
        self.jreqs = [jengine.ServeRequest(uid=r.uid, prompt=r.prompt,
                                           max_new=r.max_new) for r in self.reqs]
        self.ref, _ = self.jbase.run(self.jreqs)


def _faults() -> _Faults:
    if "faults" not in _SERVED:
        _SERVED["faults"] = _Faults()
    return _SERVED["faults"]


def test_stored_blocks_are_never_written():
    """Snapshot every block the cache holds, serve 6 more requests (which
    splice hits into slots and decode over them in place), and find every
    block byte-equal to its snapshot."""
    s = _served("llama3.2-1b")
    tc = PrefixCache(s.cfg, block_size=8, budget_blocks=64, device=CPU)
    eng = ContinuousServingEngine(s.cfg, s.params, slots=SLOTS, max_len=MAX_LEN,
                                  macro_steps=4, prefix_cache=tc, device=CPU)
    eng.run(s.reqs)
    nodes = list(tc._payload_nodes)
    leaves = lambda n: [t for t in pc_mod.tree_leaves((n.kv, n.logits))  # noqa: E731
                        if torch.is_tensor(t)]
    snap = [[t.clone() for t in leaves(n)] for n in nodes]
    assert sum(map(len, snap)) > len(nodes)
    rng = np.random.default_rng(5)
    more = [ServeRequest(uid=10 + i, max_new=4 + i % 3, prompt=np.concatenate(
        [s.reqs[i % 5].prompt[:SHARED + 4 * (i % 2)],
         rng.integers(0, s.cfg.vocab_size, (4 - 4 * (i % 2),)).astype(np.int32)]))
        for i in range(6)]
    for kw in (dict(macro_steps=0), dict(macro_steps=4, overlap_admission=False),
               dict(macro_steps=4)):
        e = ContinuousServingEngine(s.cfg, s.params, slots=SLOTS,
                                    max_len=MAX_LEN, prefix_cache=tc,
                                    device=CPU, **kw)
        _, stats = e.run(more)
        assert stats.prefix_hits == len(more)
    for n, saved in zip(nodes, snap):
        for t, want in zip(leaves(n), saved):
            assert torch.equal(t, want)
