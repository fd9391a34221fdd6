"""The port's continuous-batching engine against the JAX package's: the
same params and requests give the same per-uid token streams, the same
count and byte stats and the same ``on_tokens`` events, in every schedule
(per-step, boundary, overlapped, ``wave_steps=2``) and every cache family
the port has (dense KV, MoE, SSM conv + state, hybrid), at reduced size in
float32.  Also the admission ops and slot writes leaf for leaf."""
import dataclasses
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.serving.engine import (ContinuousServingEngine,  # noqa: E402
                                        ServeRequest, ServingEngine)

FAMILIES = ["llama3.2-1b", "moonshot-v1-16b-a3b", "falcon-mamba-7b",
            "zamba2-2.7b"]
SLOTS, MAX_LEN, PROMPT = 2, 48, 8
MODES = {"per-step": dict(macro_steps=0),
         "boundary": dict(macro_steps=4, overlap_admission=False),
         "overlapped": dict(macro_steps=4),
         "wave2": dict(macro_steps=4, wave_steps=2)}
# every ContinuousStats field that is a count or a byte total (the walls
# differ by nature); all must equal JAX's for the same schedule
COUNT_STATS = ("requests", "total_tokens", "decode_steps", "occupancy",
               "host_syncs", "macro_dispatches", "wave_launches",
               "admission_stalls", "shadow_prefills", "prefill_offloaded",
               "prefill_fallbacks", "prefix_hits", "prefix_blocks_reused",
               "prefill_flops_avoided", "prefill_flops_total",
               "kv_hop_bytes_raw", "kv_hop_bytes_wire")


class Family:
    """One architecture at reduced size in both packages, with the JAX
    per-step engine every JAX engine of the module shares programs with."""

    def __init__(self, arch: str):
        self.jcfg = jreduced(jget_config(arch))
        self.jparams = jM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.cfg = reduced(get_config(arch))
        self.params = convert.params_from_numpy(
            jax.tree.map(np.asarray, self.jparams), self.cfg, device="cpu")
        self.jbase = jengine.ContinuousServingEngine(
            self.jcfg, self.jparams, slots=SLOTS, max_len=MAX_LEN,
            macro_steps=0)
        rng = np.random.default_rng(0)
        self.probe = rng.integers(0, self.cfg.vocab_size, (PROMPT,)).astype(np.int32)
        ref, _ = self.jbase.run([jengine.ServeRequest(uid=0, prompt=self.probe,
                                                      max_new=8)])
        self.eos = int(ref[0].tokens[1])     # fires on the probe's 2nd token

    def jrun(self, reqs, **kw):
        eng = jengine.ContinuousServingEngine(
            self.jcfg, self.jparams, slots=SLOTS, max_len=MAX_LEN,
            share_from=self.jbase, **kw)
        events = []
        outs, stats = eng.run([jengine.ServeRequest(uid=r.uid, prompt=r.prompt,
                                                    max_new=r.max_new)
                               for r in reqs],
                              on_tokens=lambda *a: events.append(a))
        return outs, stats, events

    def run(self, reqs, **kw):
        eng = ContinuousServingEngine(self.cfg, self.params, slots=SLOTS,
                                      max_len=MAX_LEN, device="cpu", **kw)
        events = []
        outs, stats = eng.run(reqs, on_tokens=lambda *a: events.append(a))
        return outs, stats, events

    def requests(self, seed: int, max_news):
        """The admission-property schedule: request 0 is the probe prompt
        (so the probe's eos truncates it mid-macro-step), the rest random."""
        rng = np.random.default_rng(seed)
        return [ServeRequest(uid=i, max_new=int(m), prompt=self.probe if i == 0
                             else rng.integers(0, self.cfg.vocab_size,
                                               (PROMPT,)).astype(np.int32))
                for i, m in enumerate(max_news)]


_FAMILIES = {}


def _family(arch: str) -> Family:
    if arch not in _FAMILIES:
        _FAMILIES[arch] = Family(arch)
    return _FAMILIES[arch]


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    return _family(request.param)


def _same_streams(a, b):
    assert [o.uid for o in a] == [o.uid for o in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens, err_msg=f"uid {x.uid}")
        assert (x.admitted_step, x.finished_step) == \
            (y.admitted_step, y.finished_step), x.uid


def _same_stats(got, want):
    for name in COUNT_STATS:
        assert getattr(got, name) == pytest.approx(getattr(want, name)), name
    assert got.t_kv_transfer_s == pytest.approx(want.t_kv_transfer_s, rel=1e-6)


# ---------------------------------------------------------------------------
def test_dataclasses_match_jax():
    # the port's stats add the decode-graph counters, and nothing else
    graph_counts = [(n, 0) for n in engine.decode_graph.DecodeGraphs.COUNTS]
    assert [(f.name, f.default) for f in dataclasses.fields(
        engine.ContinuousStats)] == [
        (f.name, f.default) for f in dataclasses.fields(
            jengine.ContinuousStats)] + graph_counts
    for ours, theirs in ((engine.ServeRequest, jengine.ServeRequest),
                         (engine.RequestOutput, jengine.RequestOutput),
                         (engine._Slot, jengine._Slot)):
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)], ours
    # the port's shadow adds the event its splice waits on, and nothing else
    names = [f.name for f in dataclasses.fields(engine._Shadow)]
    assert names == [f.name for f in dataclasses.fields(jengine._Shadow)] + ["ready"]
    # the stats' names and annotations are the pinned telemetry schema's
    golden = json.loads((Path(__file__).parent / "golden" /
                         "telemetry_schema.json").read_text())
    assert {f.name: str(f.type) for f in dataclasses.fields(
        engine.ContinuousStats)} == dict(golden["continuous_stats"], **{
            name: "int" for name, _ in graph_counts})


@pytest.mark.parametrize("mode", sorted(MODES))
def test_modes_match_jax(fam, mode):
    """tests/test_continuous_batching.py's mixed schedule (P=8, max_news
    [1,6,3,9,4]: an admission-time eviction, mid-macro finishes, a run over
    three macro-steps) in every schedule."""
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, fam.cfg.vocab_size, (5, PROMPT)).astype(np.int32)
    reqs = [ServeRequest(uid=i, prompt=prompts[i], max_new=m)
            for i, m in enumerate([1, 6, 3, 9, 4])]
    jouts, jstats, jevents = fam.jrun(reqs, **MODES[mode])
    outs, stats, events = fam.run(reqs, **MODES[mode])
    _same_streams(outs, jouts)
    _same_stats(stats, jstats)
    assert events == jevents
    if MODES[mode]["macro_steps"]:
        assert stats.decode_s == stats.t_dispatch_s + stats.t_await_s


@pytest.mark.parametrize("seed,max_news,k,use_eos", [
    (11, [3, 1, 7, 2, 9, 1, 4], 1, True),
    (12, [9, 9, 2, 5], 3, False),
    (13, [2, 8, 1, 1, 6, 3, 5, 4, 9], 4, True),
    (99, [13, 9, 1, 1, 1, 1, 2, 2], 4, False),   # a run of singles
])
def test_admission_schedules_match_jax(fam, seed, max_news, k, use_eos):
    """tests/test_admission_properties.py's schedules: the overlapped
    streams, stats and events equal JAX's, the boundary streams equal the
    overlapped ones, and overlapped admission never stalls."""
    eos = fam.eos if use_eos else None
    reqs = fam.requests(seed, max_news)
    jouts, jstats, jevents = fam.jrun(reqs, macro_steps=k, eos_id=eos)
    outs, stats, events = fam.run(reqs, macro_steps=k, eos_id=eos)
    bouts, bstats, _ = fam.run(reqs, macro_steps=k, eos_id=eos,
                               overlap_admission=False)
    _same_streams(outs, jouts)
    _same_stats(stats, jstats)
    assert events == jevents
    for a, b in zip(outs, bouts):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert stats.admission_stalls == 0
    assert stats.total_tokens == bstats.total_tokens


def test_continuous_matches_static_and_eos():
    """Continuous streams equal the static ServingEngine's; an eos that
    lands mid-macro-step truncates a request inclusively, as in JAX."""
    f = _family("llama3.2-1b")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, f.cfg.vocab_size, (6, PROMPT)).astype(np.int32)
    max_news = [1, 4, 2, 5, 3, 4]
    static = ServingEngine(f.cfg, f.params, max_len=32, device="cpu")
    want = static.generate(prompts, max_new=max(max_news)).tokens
    reqs = [ServeRequest(uid=i, prompt=prompts[i], max_new=m)
            for i, m in enumerate(max_news)]
    outs, stats, _ = f.run(reqs)
    assert stats.requests == 6 and stats.total_tokens == sum(max_news)
    for o in outs:
        np.testing.assert_array_equal(o.tokens, want[o.uid][:max_news[o.uid]])
    eos = int(outs[3].tokens[2])
    for kw in (MODES["per-step"], MODES["overlapped"]):
        jouts, _, _ = f.jrun(reqs, eos_id=eos, **kw)
        outs, _, _ = f.run(reqs, eos_id=eos, **kw)
        _same_streams(outs, jouts)
        assert any(len(o.tokens) < max_news[o.uid] for o in outs)


def test_empty_and_single_request():
    f = _family("llama3.2-1b")
    eng = ContinuousServingEngine(f.cfg, f.params, slots=2, max_len=32,
                                  device="cpu")
    outs, stats = eng.run([])
    assert outs == [] and stats.total_tokens == 0
    outs, stats = eng.run([ServeRequest(uid=0, prompt=np.ones((8,), np.int32),
                                        max_new=1)])
    assert len(outs) == 1 and len(outs[0].tokens) == 1
    assert stats.decode_steps == 0      # the first token is the prefill's
    with pytest.raises(ValueError, match="overlapped fused path"):
        ContinuousServingEngine(f.cfg, f.params, macro_steps=0,
                                prefill_worker=object(), device="cpu")
    with pytest.raises(ValueError, match="wave_steps"):
        ContinuousServingEngine(f.cfg, f.params, macro_steps=0, wave_steps=2,
                                device="cpu")


# ---------------------------------------------------------------------------
# admission ops and slot writes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("admitted", [1, 3, 4])
def test_admit_state_matches_jax(admitted, test_seed):
    """admit_state at padded widths (the last real entry repeated)."""
    rng = np.random.default_rng(test_seed + admitted)
    B, V, eos = 4, 11, 5
    state = [rng.integers(0, 9, B).astype(np.int32) for _ in range(3)]
    done = rng.random(B) < 0.5
    slots = rng.permutation(B)[:admitted].astype(np.int32)
    logits = rng.standard_normal((admitted, V)).astype(np.float32)
    logits[0, eos] = 9.0                 # the first admitted hits eos
    plens = rng.integers(4, 9, admitted).astype(np.int32)
    mnews = rng.integers(1, 4, admitted).astype(np.int32)
    pad = B - admitted
    args = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
            for a in (slots, logits, plens, mnews)]
    want = jops.admit_slots(*[jnp.asarray(a) for a in state + [done]],
                            *[jnp.asarray(a) for a in args], eos_id=eos)
    got = ops.admit_slots(*[torch.from_numpy(a.copy()) for a in state + [done]],
                          *[torch.from_numpy(a) for a in args], eos_id=eos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape,src_rows", [((2, 4, 10, 3, 5), 6),
                                            ((2, 4, 3, 7), None)])
def test_splice_blocks_matches_jax(shape, src_rows, test_seed):
    """A K/V leaf (rows at offset 0) and a same-shape state leaf, with a
    padded slot vector."""
    rng = np.random.default_rng(test_seed)
    dst = rng.standard_normal(shape).astype(np.float32)
    src_shape = list(shape)
    src_shape[1] = 4
    if src_rows:
        src_shape[2] = src_rows
    src = rng.standard_normal(src_shape).astype(np.float32)
    src[:, 3] = src[:, 2]                # the padded entry repeats the last
    ids = np.array([3, 0, 2, 2], np.int32)
    want = jops.splice_blocks(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(ids))
    got = ops.splice_blocks(torch.from_numpy(dst.copy()), torch.from_numpy(src),
                            torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_slot_writes_match_jax(fam, test_seed):
    """write_slot_cache, splice_slot_caches (a padded block list) and
    admit_boundary over the family's cache tree, against JAX's."""
    rng = np.random.default_rng(test_seed)
    jcfg, cfg = fam.jcfg, fam.cfg
    big = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
                       jM.init_cache(jcfg, 4, 16))
    pre = []
    for _ in range(2):       # the engines' compiled B=1 prefill
        toks = rng.integers(0, cfg.vocab_size, (1, PROMPT)).astype(np.int32)
        pre.append(fam.jbase.prefill(fam.jparams, {"tokens": toks})[1])
    port = lambda t: convert.cache_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    flat = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]  # noqa: E731
    tflat = lambda t: [x.numpy() for x in engine.tree_leaves(t)]  # noqa: E731

    want = jengine.write_slot_cache(jcfg, big, pre[0], 2)
    got = engine.write_slot_cache(cfg, port(big), port(pre[0]), 2)
    for g, w in zip(tflat(got), flat(want)):
        np.testing.assert_array_equal(g, w)

    ids = np.array([1, 3, 3, 3], np.int32)
    blocks = [pre[0], pre[1], pre[1], pre[1]]
    state = [np.zeros(4, np.int32)] * 3 + [np.ones(4, bool)]
    logits = rng.standard_normal((4, cfg.vocab_size)).astype(np.float32)
    vecs = [np.full(4, 6, np.int32), np.array([3, 5, 5, 5], np.int32)]
    want = jengine.admit_boundary(jcfg, big, tuple(blocks), jnp.asarray(ids),
                                  *map(jnp.asarray, state), jnp.asarray(logits),
                                  *map(jnp.asarray, vecs), eos_id=-1)
    got = engine.admit_boundary(cfg, port(big), [port(b) for b in blocks],
                                torch.from_numpy(ids),
                                *[torch.from_numpy(a.copy()) for a in state],
                                torch.from_numpy(logits),
                                *map(torch.from_numpy, vecs))
    for g, w in zip(tflat(got[0]), flat(want[0])):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the decode launcher and the kernel build under threads
# ---------------------------------------------------------------------------
def test_decode_launcher_inline_then_threaded():
    """The first submit of a program runs inline and returns its result;
    later ones run on the one worker thread, under no_grad, and return a
    future."""
    launcher = engine._DecodeLauncher(torch.device("cpu"))
    seen = []

    def fn(x):
        seen.append((threading.current_thread().name, torch.is_grad_enabled()))
        return x + 1

    assert launcher.submit(fn, 1) == 2
    futs = [launcher.submit(fn, i) for i in range(3)]
    assert [f.result(timeout=30) for f in futs] == [1, 2, 3]
    assert seen[0][0] == threading.current_thread().name
    assert {name for name, _ in seen[1:]} == {"decode-launch_0"}
    assert not any(grad for _, grad in seen[1:])


def test_kernel_build_runs_once_under_threads(monkeypatch, tmp_path):
    """Threads that make their first launch together start one build: the
    lock serialises build(), and the stamp then skips it."""
    from repro_torch.kernels import _build
    calls = []

    def fake_run_all(cmds):
        calls.append(len(cmds))
        for cmd in cmds:
            out = cmd[cmd.index("-o") + 1]
            open(out, "w").write("obj")
        return ""

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run_all", fake_run_all)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=_build.build) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert calls == [len(_build._sources()), 1]   # one compile, one link
    assert (tmp_path / _build.LIB_NAME).exists()


def test_per_step_loop_makes_no_launch():
    """On the CPU every kernel call takes its plain version."""
    f = _family("llama3.2-1b")
    ops.reset_launch_counts()
    f.run([ServeRequest(uid=0, prompt=f.probe, max_new=3)], macro_steps=2)
    assert set(ops.launch_counts().values()) == {0}
    assert M.count_params_analytic(f.cfg) == jM.count_params_analytic(f.jcfg)
