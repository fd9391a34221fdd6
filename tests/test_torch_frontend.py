"""The port's asyncio ingress (ServingFrontend) against the JAX package's,
replaying the reference's frontend cases on both packages with the same
params and prompts (reduced llama3.2-1b in float32, weights carried across
by ``repro_torch.convert``): two-tenant streams, typed backpressure before
queueing, fleet-hot shedding, busy-hot re-routing, a decode group dying
(killed or wedged) with streams open, the fleet dead before any token, and
the wave accounting under a group kill.  Each case's outcomes (every
stream's tokens, every refusal's and abort's type, the per-tenant
TenantStats counts, the runtime totals and waves served) equal JAX's
exactly, and every completed stream equals the per-step engine's.  The
deficit round-robin is held against JAX's TenantScheduler as a property.
Latencies (TTFT/ITL) are wall clocks and only checked for shape."""
import asyncio
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from _hypothesis_compat import given, settings, strategies as st  # noqa: E402

import repro.core as JC  # noqa: E402
import repro.core.topology as jtopology  # noqa: E402
import repro_torch.core as C  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import frontend as jfrontend  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.serving import frontend  # noqa: E402
from repro_torch.serving.engine import (ContinuousServingEngine,  # noqa: E402
                                        ServeRequest)

SLOTS, MAX_LEN, PROMPT, MACRO_K = 2, 48, 8, 4
MAX_NEWS = [1, 6, 3, 1, 7, 4, 2, 5]   # churny: singles + mixed lengths
JDEV, TDEV = jax.devices()[0], torch.device("cpu")
STAT_COUNTS = ("submitted", "accepted", "completed", "refused_queue", "shed",
               "aborted", "max_queue_depth", "priority", "weight",
               "deadline_s")


@pytest.fixture(scope="module")
def llama():
    jcfg = jreduced(jget_config("llama3.2-1b"))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("llama3.2-1b"))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                       device="cpu")
    jbase = jengine.ContinuousServingEngine(jcfg, jparams, slots=SLOTS,
                                            max_len=MAX_LEN)
    return jcfg, jparams, cfg, params, jbase


@pytest.fixture(scope="module")
def prompts(llama):
    rng = np.random.default_rng(0)
    return rng.integers(0, llama[2].vocab_size,
                        (len(MAX_NEWS), PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_streams(llama, prompts):
    """The port's per-step engine, keyed by submission index."""
    eng = ContinuousServingEngine(llama[2], llama[3], slots=SLOTS,
                                  max_len=MAX_LEN, macro_steps=0, device="cpu")
    outs, _ = eng.run([ServeRequest(uid=i, prompt=prompts[i], max_new=m)
                       for i, m in enumerate(MAX_NEWS)])
    return {o.uid: np.asarray(o.tokens, np.int32) for o in outs}


@contextlib.contextmanager
def _jax_programs_shared(jbase):
    """Every JAX engine built meanwhile reuses ``jbase``'s jitted programs
    (the reference's own ``share_from``): no recompiles, same schedule."""
    made = jtopology.ContinuousServingEngine

    def shared(cfg, params, **kw):
        if kw.get("share_from") is None and cfg is jbase.cfg:
            kw["share_from"] = jbase
        return made(cfg, params, **kw)

    jtopology.ContinuousServingEngine = shared
    try:
        yield
    finally:
        jtopology.ContinuousServingEngine = made


class Side:
    """One package's names: JAX's or the port's."""

    def __init__(self, jax_side: bool, llama):
        jcfg, jparams, cfg, params, self.jbase = llama
        self.jax = jax_side
        self.C = JC if jax_side else C
        self.fe = jfrontend if jax_side else frontend
        self.dev = JDEV if jax_side else TDEV
        self.cfg, self.params = (jcfg, jparams) if jax_side else (cfg, params)
        self.Req = jengine.ServeRequest if jax_side else ServeRequest

    def tenants(self):
        return {"interactive": self.C.TenantClass("interactive", priority=0,
                                                  weight=2.0, deadline_s=0.5),
                "batch": self.C.TenantClass("batch", priority=1, weight=1.0)}


def _runtime(side, kind, *, busy_aux=False, drained=False):
    Cm = side.C
    aux = dataclasses.replace(Cm.JETSON_XAVIER, busy_factor=0.95) \
        if busy_aux else Cm.JETSON_XAVIER
    if kind == "pair":
        topo = Cm.Topology.pair(Cm.NodeGroup("pri", [side.dev], Cm.JETSON_NANO),
                                Cm.NodeGroup("aux", [side.dev], aux),
                                Cm.ICI_LINK)
    else:
        topo = Cm.Topology.star(Cm.NodeGroup("pri", [side.dev], Cm.JETSON_NANO),
                                [Cm.NodeGroup("aux0", [side.dev], aux),
                                 Cm.NodeGroup("aux1", [side.dev], aux)],
                                Cm.ICI_LINK)
    budgets = None
    if drained:
        budgets = {g.name: Cm.GroupBudget(battery=Cm.BatteryState(capacity_wh=0.0))
                   for g in topo.groups}
    rt = Cm.HeteroRuntime(topo, slots=SLOTS, max_len=MAX_LEN,
                          macro_steps=MACRO_K, group_budgets=budgets)
    rt.add_task(side.cfg.name, side.cfg, side.params)
    rt.warmup([side.Req(uid=0, prompt=np.zeros(PROMPT, np.int32), max_new=2,
                        task=side.cfg.name)])
    return topo, rt


def _drive(side, rt, prompts, *, queue_depth=64, shed_depth=None,
           wave_requests=None, n=len(MAX_NEWS)):
    """Submit n requests round-robin across the tenants (all before the
    serve loop runs: submit never yields), then collect every stream."""
    async def go():
        fe = side.fe.ServingFrontend(rt, side.tenants(), split=0.5,
                                     queue_depth=queue_depth,
                                     shed_depth=shed_depth,
                                     wave_requests=wave_requests)
        await fe.start()
        streams, refused = {}, []
        names = sorted(side.tenants())
        for i in range(n):
            try:
                s = await fe.submit(prompts[i], MAX_NEWS[i],
                                    tenant=names[i % len(names)],
                                    task=side.cfg.name)
                streams[i] = s
            except (side.fe.QueueFullError, side.fe.RequestShedError) as e:
                refused.append((i, type(e).__name__, e.tenant))
        outs, errs = {}, {}
        for i, s in streams.items():
            try:
                outs[i] = await s.collect()
            except side.fe.RequestAbortedError as e:
                errs[i] = (type(e).__name__, e.tenant)
        tel = fe.telemetry()
        await fe.stop()
        return streams, outs, errs, tel, refused, fe
    return asyncio.run(go())


def _case(llama, prompts, kind, *, runtime_kw=None, chaos=None, **drive_kw):
    """Run one case on both packages; returns (port, jax) results."""
    results = []
    for jax_side in (True, False):
        side = Side(jax_side, llama)
        ctx = _jax_programs_shared(side.jbase) if jax_side \
            else contextlib.nullcontext()
        with ctx:
            topo, rt = _runtime(side, kind, **(runtime_kw or {}))
            if chaos is not None:
                chaos(topo)
            results.append((topo, rt) + _drive(side, rt, prompts, **drive_kw))
    return results[1], results[0]


def _same_outcomes(got, want, ref_streams):
    _, _, g_streams, g_outs, g_errs, g_tel, g_ref, _ = got
    _, _, w_streams, w_outs, w_errs, w_tel, w_ref, _ = want
    assert g_ref == w_ref                       # refusals: index, type, tenant
    assert g_errs == w_errs                     # aborts: index, type, tenant
    assert sorted(g_outs) == sorted(w_outs) and sorted(g_streams) == sorted(w_streams)
    for i, toks in w_outs.items():
        np.testing.assert_array_equal(g_outs[i], toks)
        np.testing.assert_array_equal(g_outs[i], ref_streams[i])
        assert g_streams[i].tokens == list(g_outs[i])      # stream == collect
        assert len(g_streams[i].itl_s) == len(w_streams[i].itl_s)
        assert (g_streams[i].ttft_s > 0) == (w_streams[i].ttft_s > 0)
    for i in g_errs:
        assert g_streams[i].tokens == [] == w_streams[i].tokens
    for key in ("queue_depth", "shed_depth", "wave_requests", "waves_served",
                "backlog", "runtime"):
        assert g_tel[key] == w_tel[key], key
    assert sorted(g_tel["tenants"]) == sorted(w_tel["tenants"])
    for name, wt in w_tel["tenants"].items():
        gt = g_tel["tenants"][name]
        assert set(gt) == set(wt)
        assert {k: gt[k] for k in STAT_COUNTS} == {k: wt[k] for k in STAT_COUNTS}
        assert (gt["ttft_p99_s"] > 0) == (wt["ttft_p99_s"] > 0)


# --- the end-to-end cases (the reference's frontend tier) --------------------------------
def test_two_tenant_streams_equal(llama, prompts, ref_streams):
    got, want = _case(llama, prompts, "pair")
    _same_outcomes(got, want, ref_streams)
    tel = got[5]
    assert not got[6] and not got[4] and len(got[3]) == len(MAX_NEWS)
    for t in tel["tenants"].values():
        assert t["completed"] == t["accepted"] == len(MAX_NEWS) // 2
    assert tel["runtime"]["admission_rerouted"] == 0
    assert tel["runtime"]["tokens"] == sum(MAX_NEWS)
    for i, s in got[2].items():
        assert len(s.itl_s) == MAX_NEWS[i] - 1


def test_backpressure_refuses_typed_before_queueing(llama, prompts, ref_streams):
    got, want = _case(llama, prompts, "pair", queue_depth=2)
    _same_outcomes(got, want, ref_streams)
    assert len(got[6]) == len(MAX_NEWS) - 2
    assert {r[1] for r in got[6]} == {"QueueFullError"} and len(got[3]) == 2


def test_fleet_hot_sheds_typed(llama, prompts, ref_streams):
    got, want = _case(llama, prompts, "pair", runtime_kw=dict(drained=True),
                      shed_depth=1)
    assert got[1].admission.fleet_hot()
    _same_outcomes(got, want, ref_streams)
    assert {r[1] for r in got[6]} == {"RequestShedError"}
    assert len(got[6]) == len(MAX_NEWS) - 1 and len(got[2]) == 1


def test_busy_hot_group_reroutes(llama, prompts, ref_streams):
    got, want = _case(llama, prompts, "pair", runtime_kw=dict(busy_aux=True))
    _same_outcomes(got, want, ref_streams)
    assert got[5]["runtime"]["admission_rerouted"] > 0


@pytest.mark.parametrize("timeout", [False, True], ids=["killed", "wedged"])
def test_group_dies_with_streams_open(llama, prompts, ref_streams, timeout):
    def chaos(topo):
        topo.groups[1].inject_fault("dispatch", after=1, timeout=timeout)
    got, want = _case(llama, prompts, "star", chaos=chaos, wave_requests=4)
    _same_outcomes(got, want, ref_streams)
    assert not got[0].groups[1].alive and len(got[3]) == len(MAX_NEWS)
    for i, toks in got[3].items():
        assert len(toks) == MAX_NEWS[i]               # no duplicated tail
    assert got[5]["runtime"]["wave_requeued"] >= 1


def test_fleet_dead_aborts_typed_before_tokens(llama, prompts, ref_streams):
    def chaos(topo):
        for g in topo.groups:
            g.kill()
    got, want = _case(llama, prompts, "pair", chaos=chaos, n=4)
    _same_outcomes(got, want, ref_streams)
    assert not got[3] and len(got[4]) == 4
    assert {e[0] for e in got[4].values()} == {"RequestAbortedError"}
    assert sum(t["aborted"] for t in got[5]["tenants"].values()) == 4


def test_wave_accounting_under_group_kill(llama, prompts, ref_streams):
    def chaos(topo):
        topo.groups[1].inject_fault("dispatch", after=1)
    got, want = _case(llama, prompts, "star", chaos=chaos, wave_requests=4)
    _same_outcomes(got, want, ref_streams)
    assert got[5]["waves_served"] == 2
    assert got[5]["runtime"] == {"wave_requeued": 1, "wave_retries": 1,
                                 "admission_stalls": 0,
                                 "admission_rerouted": 0,
                                 "tokens": sum(MAX_NEWS)}


def test_submit_errors_equal(llama, prompts):
    msgs = []
    for jax_side in (True, False):
        side = Side(jax_side, llama)
        _, rt = _runtime(side, "pair")
        out = []
        with pytest.raises(ValueError) as ei:
            side.fe.ServingFrontend(rt, side.tenants(), queue_depth=0)
        out.append(str(ei.value))
        fe = side.fe.ServingFrontend(rt, side.tenants())

        async def go():
            with pytest.raises(RuntimeError) as e1:
                await fe.submit(prompts[0], 2, tenant="batch")
            await fe.start()
            with pytest.raises(KeyError) as e2:
                await fe.submit(prompts[0], 2, tenant="nope")
            await fe.stop()
            return [str(e1.value), str(e2.value)]
        out += asyncio.run(go())
        tel = fe.telemetry()
        out.append((tel["shed_depth"], tel["wave_requests"], tel["backlog"]))
        msgs.append(out)
    assert msgs[1] == msgs[0]


def test_frontend_thread_runs_waves_without_grad(llama, prompts, ref_streams):
    """The serve worker thread keeps grad mode off (PyTorch holds it per
    thread) and the streams are the per-step engine's."""
    side = Side(False, llama)
    _, rt = _runtime(side, "pair")
    seen = []
    serve = rt.serve

    def spy(*a, **kw):
        seen.append(torch.is_grad_enabled())
        return serve(*a, **kw)

    rt.serve = spy
    streams, outs, errs, tel, refused, _ = _drive(side, rt, prompts)
    assert seen and not any(seen)
    for i, toks in outs.items():
        np.testing.assert_array_equal(toks, ref_streams[i])


# --- tenant fairness: DRR against JAX's TenantScheduler ------------------------------
@settings(max_examples=30, deadline=None)
@given(weights=st.lists(st.integers(1, 8), min_size=2, max_size=4),
       counts=st.lists(st.integers(0, 12), min_size=2, max_size=4),
       batch=st.integers(1, 5))
def test_tenant_drr_conservation_equal_to_jax(weights, counts, batch):
    """Any arrival pattern drains exactly once, FIFO within a tenant,
    urgent classes first in each wave, and wave for wave the same picks as
    JAX's scheduler."""
    k = min(len(weights), len(counts))
    scheds = []
    for mod in (JC, C):
        tenants = {f"t{i}": mod.TenantClass(f"t{i}", priority=i % 2,
                                            weight=weights[i] / 2.0)
                   for i in range(k)}
        sched = mod.TenantScheduler(tenants)
        for i in range(k):
            for j in range(counts[i]):
                sched.enqueue(f"t{i}", (i, j))
        scheds.append((sched, tenants))
    (js, _), (ts, tenants) = scheds
    served = {t: [] for t in tenants}
    waves, total = 0, sum(counts[:k])
    while ts.backlog():
        before = ts.backlog()
        picked = ts.select(batch)
        assert picked == js.select(batch)
        assert len(picked) == min(batch, before)
        pris = [tenants[t].priority for t, _ in picked]
        assert pris == sorted(pris)
        for t, item in picked:
            served[t].append(item)
        waves += 1
        assert waves <= total + 1
    assert js.backlog() == 0
    for i in range(k):
        assert served[f"t{i}"] == [(i, j) for j in range(counts[i])]


@settings(max_examples=20, deadline=None)
@given(w_hog=st.integers(1, 16), n_waves=st.integers(8, 48))
def test_tenant_drr_no_starvation_equal_to_jax(w_hog, n_waves):
    served = []
    for mod in (JC, C):
        sched = mod.TenantScheduler({
            "hog": mod.TenantClass("hog", priority=0, weight=float(w_hog)),
            "victim": mod.TenantClass("victim", priority=1, weight=0.25)})
        picks = []
        for r in range(n_waves):
            for _ in range(4):
                sched.enqueue("hog", ("hog", r))
            sched.enqueue("victim", ("victim", r))
            picks.append(sched.select(2))
        served.append(picks)
    assert served[1] == served[0]
    n_victim = sum(t == "victim" for wave in served[1] for t, _ in wave)
    assert n_victim >= n_waves // 4 - 2
