"""The port's HeteroRuntime against the JAX package's, at reduced size in
float32, on the same params (carried across by ``repro_torch.convert``) and
the same requests (numpy, seeded): per-uid streams, per-wave and per-group
counts and every integer, boolean and string field of the telemetry equal
to JAX's, under fixed splits on a pair and a 3-group star and under every
chaos schedule of the reference's group-fault tests (a group killed at
dispatch or await, restored within the backoff bound, the mobility latch
through a LinkTrace on a decode and on the prefill edge, every edge
latched, the prefill spoke killed and restored, the whole fleet dead), and
per cache family.  The telemetry's key set and types equal the golden
schema.  With ``split=None`` (the live controller, driven by wall clocks,
so not compared with JAX's) every uid completes once with the per-step
engine's stream and the split stays on the simplex.  The launcher's
continuous, star, prefill-group, link-trace, power-budget and frontend
paths run, and its flag errors read as the reference's.

Streams and integer telemetry are compared exactly (float32 on both sides,
greedy, the same schedule); float telemetry (walls, headrooms) is not
compared with JAX's, but every additive counter, floats included, must add
up from the groups to the waves to the totals in every session."""
import contextlib
import copy
import dataclasses
import io
import json
import math
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as JC  # noqa: E402
import repro.core.topology as jtopology  # noqa: E402
import repro_torch.core as C  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.decode_graph import DecodeGraphs  # noqa: E402
from repro_torch.serving.engine import (ContinuousServingEngine,  # noqa: E402
                                        ServeRequest)

SLOTS, MAX_LEN, PROMPT = 2, 48, 8
MAX_NEWS = [1, 6, 3, 1, 7, 4, 2, 5]   # churny: singles + mixed lengths
GOLDEN = Path(__file__).parent / "golden" / "telemetry_schema.json"
JDEV, TDEV = jax.devices()[0], torch.device("cpu")


class Model:
    """One architecture, reduced, in both packages on the same weights."""

    def __init__(self, arch: str):
        self.jcfg = jreduced(jget_config(arch))
        self.jparams = jM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.cfg = reduced(get_config(arch))
        self.params = convert.params_from_numpy(
            jax.tree.map(np.asarray, self.jparams), self.cfg, device="cpu")

    @contextlib.contextmanager
    def jax_programs_shared(self):
        """Every JAX engine built meanwhile reuses one base engine's jitted
        programs (the reference's own ``share_from``), so each JAX runtime
        does not recompile them: the schedules run as they would, faster."""
        if not hasattr(self, "_jbase"):
            self._jbase = jengine.ContinuousServingEngine(
                self.jcfg, self.jparams, slots=SLOTS, max_len=MAX_LEN)
        made = jtopology.ContinuousServingEngine

        def shared(cfg, params, **kw):
            if kw.get("share_from") is None and cfg is self.jcfg:
                kw["share_from"] = self._jbase
            return made(cfg, params, **kw)

        jtopology.ContinuousServingEngine = shared
        try:
            yield
        finally:
            jtopology.ContinuousServingEngine = made

    def requests(self, n=len(MAX_NEWS), seed=0):
        rng = np.random.default_rng(seed)
        prompts = rng.integers(0, self.cfg.vocab_size, (n, PROMPT)).astype(np.int32)
        return [(i, prompts[i], MAX_NEWS[i % len(MAX_NEWS)]) for i in range(n)]

    def per_step(self, reqs):
        """The port's all-healthy per-step reference streams."""
        eng = ContinuousServingEngine(self.cfg, self.params, slots=SLOTS,
                                      max_len=MAX_LEN, macro_steps=0,
                                      device="cpu")
        outs, _ = eng.run([ServeRequest(uid=u, prompt=p, max_new=m)
                           for u, p, m in reqs])
        return {o.uid: o.tokens for o in outs}


_MODELS = {}


def _model(arch="llama3.2-1b") -> Model:
    if arch not in _MODELS:
        _MODELS[arch] = Model(arch)
    return _MODELS[arch]


# --- one schedule, run the same way in both packages ---------------------------
def _groups(mod, dev, names, profiles=None):
    profs = profiles or [mod.JETSON_NANO] + [mod.JETSON_XAVIER] * (len(names) - 1)
    return [mod.NodeGroup(n, [dev], p) for n, p in zip(names, profs)]


class _RebootingHealth:
    """Mixin: while down, liveness reads fail ``probes_down`` times, then
    the node has 'rebooted' and reads True (the reference's chaos helper)."""

    def __init__(self, probes_down: int = 1):
        self._probes_down = int(probes_down)
        super().__init__()

    @property
    def alive(self) -> bool:
        if not self._alive and self._probes_down > 0:
            self._probes_down -= 1
            if self._probes_down == 0:
                self._alive = True
        return self._alive

    @alive.setter
    def alive(self, v: bool) -> None:
        self._alive = bool(v)


_REBOOT = {mod: type("Rebooting", (_RebootingHealth, mod.GroupHealth), {})
           for mod in (JC, C)}


def _build(mod, dev, sched):
    """(topology, runtime kwargs) of a schedule in package ``mod``."""
    names = sched.get("names", ("pri", "aux", "pf"))
    groups = _groups(mod, dev, names)
    link = getattr(mod, sched.get("link", "ICI_LINK"))
    if len(names) == 2 and sched.get("pair", True):
        topo = mod.Topology.pair(groups[0], groups[1], link)
    else:
        topo = mod.Topology.star(groups[0], groups[1:], link,
                                 prefill_spoke=sched.get("prefill"))
    for name, (kind, after, timeout) in sched.get("faults", {}).items():
        g = topo.groups[list(names).index(name)]
        if name in sched.get("reboot", ()):
            g.health = _REBOOT[mod](probes_down=1)
        g.inject_fault(kind, after=after, timeout=timeout)
    for name in sched.get("killed", ()):
        topo.groups[list(names).index(name)].kill()
    kw = dict(slots=SLOTS, max_len=MAX_LEN, macro_steps=4)
    kw.update(sched.get("rt", {}))
    if "traces" in sched:
        kw["link_traces"] = {k: mod.LinkTrace(distances=v)
                             for k, v in sched["traces"].items()}
    if topo.prefill_spoke is not None:
        # the default router compares wall-clock prefill rates, so its
        # route would differ between the packages' runs; margin 1e9 keeps
        # that comparison from vetoing remote and leaves the deterministic
        # rules (explore, probe, health, the β latch) to decide
        kw["prefill_router"] = mod.PrefillRouter(
            topo.prefill_link, **sched.get("router", dict(margin=1e9)))
    return topo, kw


def _serve(mod, model, sched, reqs):
    jax_side = mod is JC
    dev = JDEV if jax_side else TDEV
    topo, kw = _build(mod, dev, sched)
    rt = mod.HeteroRuntime(topo, **kw)
    cfg, params = (model.jcfg, model.jparams) if jax_side else (model.cfg, model.params)
    tasks = sched.get("tasks", (cfg.name,))
    for t in tasks:
        rt.add_task(t, cfg, params, **sched.get("task_kw", {}))
    Req = jengine.ServeRequest if jax_side else ServeRequest
    requests = [Req(uid=u, prompt=p, max_new=m, task=tasks[u % len(tasks)])
                for u, p, m in reqs]
    serve_kw = dict(sched.get("serve", {}))
    if isinstance(serve_kw.get("split"), tuple) \
            and serve_kw["split"][0] == "SplitVector":
        serve_kw["split"] = mod.SplitVector(serve_kw["split"][1])
    out = []
    for call in range(sched.get("calls", 1)):
        if call and "restore" in sched:
            topo.groups[[g.name for g in topo.groups].index(sched["restore"])].restore()
        try:
            res = rt.serve(requests, warm=False, **serve_kw)
        except mod.GroupUnavailableError as e:
            out.append(("raised", type(e).__name__, e.group))
            continue
        streams = {t: {o.uid: np.asarray(o.tokens) for o in outs}
                   for t, outs in res.outputs.items()}
        workers = [s.prefill_worker.healthy for s in rt.tasks.values()
                   if s.prefill_worker is not None]
        out.append((streams, res.telemetry, workers,
                    [g.alive for g in topo.groups]))
    return out


def _discrete(tree, path=""):
    """Every int / bool / str leaf of a telemetry tree, by path."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_discrete(v, f"{path}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_discrete(v, f"{path}[{i}]"))
    elif isinstance(tree, (bool, int, str, np.integer, np.bool_)):
        out[path] = tree
    return out


# the counters the port publishes beside the golden's (the JAX package's):
# the fused decode loop's graph counters, at every telemetry level
PORT_ONLY = DecodeGraphs.COUNTS


def port_schema(golden: dict) -> dict:
    """The golden schema with ``PORT_ONLY`` (ints) in each group of each
    wave, each wave and the totals, and after ContinuousStats' fields."""
    out = copy.deepcopy(golden)
    extra = {name: "int" for name in PORT_ONLY}
    tel = out["serve_result_telemetry"]
    for level in [tel["totals"], *tel["waves"]] + [
            g for w in tel["waves"] for g in w["per_group"].values()]:
        level.update(extra)
    out["continuous_stats"].update(extra)
    return out


def _port_counters_hold(tel):
    """On the CPU the fused loop never replays graphs: each group and the
    totals count no graph step and no capture, and K x W eager steps a
    launch of the fused program."""
    groups = [g for w in tel["waves"] for g in w["per_group"].values()]
    for level in [tel["totals"], *groups]:
        assert level["decode_graph_steps"] == 0
        assert level["decode_graph_captures"] == 0
        assert level["decode_eager_steps"] == level["wave_launches"] \
            * tel["wave_steps"] * tel["macro_steps"]


def _same_run(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w[0] == "raised":
            assert g == w
            continue
        gs, gt, gw, ga = g
        ws, wt, ww, wa = w
        assert sorted(gs) == sorted(ws)
        for task in ws:
            assert sorted(gs[task]) == sorted(ws[task]), task   # uid set
            for uid, toks in ws[task].items():
                np.testing.assert_array_equal(gs[task][uid], toks,
                                              err_msg=f"{task} uid {uid}")
        _port_counters_hold(gt)
        gd = {k: v for k, v in _discrete(gt).items()
              if k.rsplit("/", 1)[-1] not in PORT_ONLY}
        wd = _discrete(wt)
        assert set(gd) == set(wd)
        diff = {k: (gd[k], wd[k]) for k in wd if gd[k] != wd[k]}
        assert not diff, diff
        assert (gw, ga) == (ww, wa)
        # the float telemetry has the same keys; the fixed splits agree
        assert [w_["split"] for w_ in gt["waves"]] == \
            [w_["split"] for w_ in wt["waves"]]


def _compare(model, sched, reqs):
    with model.jax_programs_shared():
        want = _serve(JC, model, sched, reqs)
    got = _serve(C, model, sched, reqs)
    _same_run(got, want)
    return got


# --- fixed splits ------------------------------------------------------------------
FIXED = {
    "pair-0.5": dict(names=("pri", "aux"), serve=dict(split=0.5, wave=4)),
    "pair-vector": dict(names=("pri", "aux"), serve=dict(split=(0.3, 0.7))),
    "pair-per-step": dict(names=("pri", "aux"), rt=dict(macro_steps=0),
                          serve=dict(split=0.25, wave=3)),
    "star3": dict(names=("hub", "s1", "s2"), link="WIFI_5GHZ",
                  serve=dict(split=(0.4, 0.3, 0.3))),
    "star3-two-tasks-boundary": dict(
        names=("hub", "s1", "s2"), tasks=("a", "b"),
        rt=dict(overlap_admission=False),
        serve=dict(split=("SplitVector", (0.5, 0.25, 0.25)), wave=5),
        task_kw=dict(max_new=4)),
    "star3-wave2": dict(names=("hub", "s1", "s2"), rt=dict(wave_steps=2),
                        serve=dict(split=0.6)),
    "star-prefill-spoke": dict(names=("pri", "aux", "pf"), prefill="pf",
                               serve=dict(split=0.5, wave=2)),
    "star-prefill-cache-pool": dict(
        names=("pri", "aux", "pf"), prefill="pf",
        rt=dict(prefix_cache_blocks=16, prefix_block_size=4, prefill_pool=2),
        router=dict(margin=1e9), serve=dict(split=0.5, wave=4)),
    "pure-disaggregation": dict(names=("pri", "pf"), pair=False, prefill="pf"),
    "budget-hot-aux": dict(budget=True, serve=dict(split=0.5, wave=4)),
}


@pytest.mark.parametrize("name", sorted(FIXED))
def test_fixed_split_equal_to_jax(name):
    sched = FIXED[name]
    m = _model()
    reqs = m.requests(n=10, seed=3)
    if sched.get("budget"):
        got = _serve_budget(C, m, sched, reqs)
        with m.jax_programs_shared():
            want = _serve_budget(JC, m, sched, reqs)
        _same_run(got, want)
        assert got[0][1]["totals"]["admission_rerouted"] > 0
        assert got[0][1]["totals"]["admission_hot"] == {"pri": False, "aux": True}
    else:
        got = _compare(m, sched, reqs)
    cap = sched.get("task_kw", {}).get("max_new")
    ref = m.per_step([(u, p, x if cap is None else min(x, cap))
                      for u, p, x in reqs])
    for outs in got[0][0].values():
        for uid, toks in outs.items():
            np.testing.assert_array_equal(toks, ref[uid])


def _serve_budget(mod, model, sched, reqs):
    """A drained battery on aux: ``group_budgets`` needs the package's own
    GroupBudget, so the schedule is built here."""
    dev = JDEV if mod is JC else TDEV
    topo = mod.Topology.pair(*_groups(mod, dev, ("pri", "aux")), mod.ICI_LINK)
    rt = mod.HeteroRuntime(topo, slots=SLOTS, max_len=MAX_LEN, macro_steps=4,
                           group_budgets={"aux": mod.GroupBudget(
                               battery=mod.BatteryState(capacity_wh=0.0))})
    cfg, params = (model.jcfg, model.jparams) if mod is JC else (model.cfg, model.params)
    rt.add_task(cfg.name, cfg, params)
    Req = jengine.ServeRequest if mod is JC else ServeRequest
    res = rt.serve([Req(uid=u, prompt=p, max_new=m, task=cfg.name)
                    for u, p, m in reqs], warm=False, **sched["serve"])
    streams = {t: {o.uid: np.asarray(o.tokens) for o in outs}
               for t, outs in res.outputs.items()}
    return [(streams, res.telemetry, [], [g.alive for g in topo.groups])]


@pytest.mark.parametrize("case", ["golden-session", "empty-share",
                                  "killed-group"])
def test_telemetry_schema_equals_golden(case):
    """The golden schema's session (star with a prefill spoke 'prefill',
    slots 2, K=4, six requests at split 0.5) through the port: the same
    keys and value types, and OffloadReport / ContinuousStats carry the
    golden's field names.  The same session with an empty share for aux
    (split 0.0), and with aux killed at its first dispatch, gives every
    wave the golden's keys and types; a group handed no requests lists no
    tasks."""
    from test_telemetry_schema import _schema
    from repro_torch.serving.engine import ContinuousStats
    golden = port_schema(json.loads(GOLDEN.read_text()))
    m = _model()
    topo = C.Topology.star(*_split(_groups(C, TDEV, ("pri", "aux", "prefill"))),
                           C.WIFI_5GHZ, prefill_spoke="prefill")
    if case == "killed-group":
        topo.groups[1].inject_fault("dispatch", after=0)
    rt = C.HeteroRuntime(topo, slots=2, max_len=32, macro_steps=4)
    rt.add_task(m.cfg.name, m.cfg, m.params)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, m.cfg.vocab_size, (6, 8)).astype(np.int32)
    reqs = [ServeRequest(uid=i, prompt=prompts[i], max_new=1 + i % 4,
                         task=m.cfg.name) for i in range(6)]
    result = rt.serve(reqs, split=0.0 if case == "empty-share" else 0.5)
    tel = json.loads(result.to_json())
    if case == "golden-session":
        got = _schema(tel)
        assert got == golden["serve_result_telemetry"]
    else:
        want = golden["serve_result_telemetry"]
        assert _schema({**tel, "waves": []}) == {**want, "waves": []}
        aux = [w["per_group"]["aux"] for w in tel["waves"]]
        assert aux[0]["n"] == 0 and aux[0]["tasks"] == {}
        if case == "killed-group":
            assert tel["waves"][0]["wave_requeued"] >= 1
            assert aux[0]["wall_s"] == 0.0
        for w in tel["waves"]:
            want_w = copy.deepcopy(want["waves"][0])
            for name, g in w["per_group"].items():
                if not g["tasks"]:
                    want_w["per_group"][name]["tasks"] = {}
            assert _schema(w) == want_w, w["wave"]
    assert [f.name for f in dataclasses.fields(C.OffloadReport)] == \
        list(golden["offload_report"])
    assert [f.name for f in dataclasses.fields(ContinuousStats)] == \
        list(golden["continuous_stats"])


def _split(groups):
    return groups[0], groups[1:]


# --- the telemetry's levels, floats included -----------------------------------------
def _additive_keys():
    """(counters of a group and its wave, counters of a group and the
    totals only, the wave's own counters), read from the golden schema."""
    tel = port_schema(json.loads(GOLDEN.read_text()))["serve_result_telemetry"]
    wave, tot = tel["waves"][0], tel["totals"]
    group = set(wave["per_group"]["pri"]) - {"n", "wall_s", "link_s",
                                            "t_per_macro_step_s", "tasks"}
    own = {"wave_requeued", "wave_retries", "mobility_latched",
           "admission_rerouted"}
    assert group <= set(tot) and own <= set(wave) & set(tot)
    return group & set(wave), group - set(wave), own


def _sums_hold(tel):
    """Each wave's counters are the sums of its groups', the totals the
    sums over the waves (over the waves' groups where the wave carries
    none), within 1e-9 relative; the totals' rates follow from them."""
    in_wave, group_only, own = _additive_keys()
    waves, tot = tel["waves"], tel["totals"]

    def close(got, want, what):
        assert math.isclose(got, want, rel_tol=1e-9), (what, got, want)

    for w in waves:
        for k in in_wave:
            close(w[k], sum(g[k] for g in w["per_group"].values()),
                  (w["wave"], k))
    for k in in_wave | own:
        close(tot[k], sum(w[k] for w in waves), k)
    for k in group_only:
        close(tot[k], sum(g[k] for w in waves for g in w["per_group"].values()),
              k)
    close(tot["host_syncs_per_token"],
          tot["host_syncs"] / max(tot["tokens"], 1), "host_syncs_per_token")
    close(tot["tok_per_s"], tot["tokens"] / max(tot["wall_s"], 1e-9),
          "tok_per_s")
    frac = (tot["prefill_flops_avoided"] / tot["prefill_flops_total"]
            if tot["prefill_flops_total"] else 0.0)
    close(tot["prefill_flops_avoided_frac"], frac, "prefill_flops_avoided_frac")


# --- chaos schedules (the reference's group-fault tier) ---------------------------------
CHAOS = {
    **{f"kill-{v}-dispatch-after{a}": dict(faults={v: ("dispatch", a, False)},
                                           prefill="pf",
                                           serve=dict(split=0.5, wave=2))
       for v in ("pri", "aux", "pf") for a in (0, 2)},
    "kill-aux-at-await": dict(faults={"aux": ("await", 1, False)}, prefill="pf",
                              serve=dict(split=0.5, wave=2)),
    "kill-aux-timeout": dict(faults={"aux": ("dispatch", 1, True)}, prefill="pf",
                             serve=dict(split=0.5, wave=2)),
    "restore-within-backoff": dict(faults={"aux": ("dispatch", 1, False)},
                                   reboot=("aux",), prefill="pf", n=16,
                                   rt=dict(reprobe_after=2, reprobe_max=4),
                                   serve=dict(split=0.5, wave=2)),
    "prefill-group-killed-then-restored": dict(
        killed=("pf",), prefill="pf", calls=2, restore="pf",
        router=dict(reprobe_after=1, reprobe_max=2, margin=1e9),
        serve=dict(split=0.5, wave=2)),
    "mobility-latch-decode-edge": dict(prefill="pf", n=16,
                                       traces={"aux": (4.0, 30.0, 30.0, 4.0)},
                                       serve=dict(split=0.5, wave=4)),
    "mobility-latch-prefill-edge": dict(prefill="pf", n=16,
                                        traces={"pf": (4.0, 30.0, 4.0, 4.0)},
                                        router=dict(margin=1e9),
                                        serve=dict(split=0.5, wave=4)),
    "all-latched-hub-dead": dict(prefill="pf", killed=("pri",),
                                 traces={"aux": (30.0,)},
                                 serve=dict(split=0.5, wave=4)),
    "all-decode-dead": dict(prefill="pf", killed=("pri", "aux"),
                            serve=dict(split=0.5, wave=2)),
}


@pytest.mark.parametrize("name", sorted(CHAOS))
def test_chaos_schedule_equal_to_jax(name):
    sched = CHAOS[name]
    m = _model()
    reqs = m.requests(n=sched.get("n", len(MAX_NEWS)))
    got = _compare(m, sched, reqs)
    ref = m.per_step(reqs)
    for run in got:
        if run[0] == "raised":
            assert name == "all-decode-dead" and run[2] == "all"
            continue
        streams, tel, _, _ = run
        assert sorted(streams[m.cfg.name]) == sorted(ref)   # each uid once
        for uid, toks in streams[m.cfg.name].items():
            np.testing.assert_array_equal(toks, ref[uid])
    tot = got[-1][1]["totals"] if got[-1][0] != "raised" else None
    if name.startswith("kill-") and "pf" not in name:
        assert tot["wave_requeued"] >= 1 and tot["wave_retries"] >= 1
    if name == "restore-within-backoff":
        alive = [w["group_alive"]["aux"] for w in got[0][1]["waves"]]
        died = alive.index(False)
        assert died + alive[died:].index(True) - died <= 3 and alive[-1]
    if name == "prefill-group-killed-then-restored":
        assert got[0][2] == [False] and got[1][2] == [True]
        assert got[1][1]["waves"][-1]["prefill_route"] == "remote"


SESSIONS = {**{f"fixed-{k}": (v, dict(n=10, seed=3)) for k, v in FIXED.items()},
            **{f"chaos-{k}": (v, dict(n=v.get("n", len(MAX_NEWS))))
               for k, v in CHAOS.items()}}


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_additive_telemetry_sums_over_levels(name):
    """Every fixed-split and chaos session through the port alone: the
    float telemetry JAX's comparison leaves out (walls, FLOPs, bytes) adds
    up from the groups to the waves to the totals, as the integers do."""
    sched, req_kw = SESSIONS[name]
    m = _model()
    serve_fn = _serve_budget if sched.get("budget") else _serve
    runs = serve_fn(C, m, sched, m.requests(**req_kw))
    served = [run for run in runs if run[0] != "raised"]
    assert served or name == "chaos-all-decode-dead"
    for _, tel, _, _ in served:
        assert tel["waves"]
        _sums_hold(tel)


# --- per cache family ----------------------------------------------------------------
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "llama3.2-1b"])
def test_recovery_per_family_equal_to_jax(arch):
    """Mid-serve spoke death + re-queue per cache family (the int8 and vlm
    cases wait for their port): the same streams, re-queues and liveness as
    JAX's, and the per-step engine's streams."""
    m = _model(arch)
    reqs = m.requests(n=6, seed=7)
    sched = dict(faults={"aux": ("dispatch", 1, False)}, prefill="pf",
                 serve=dict(split=0.5, wave=2))
    got = _compare(m, sched, reqs)
    streams, tel, _, _ = got[0]
    ref = m.per_step(reqs)
    assert sorted(streams[m.cfg.name]) == sorted(ref)
    for uid, toks in streams[m.cfg.name].items():
        np.testing.assert_array_equal(toks, ref[uid])
    assert tel["totals"]["wave_requeued"] >= 1
    assert tel["totals"]["group_alive"]["aux"] is False


# --- the live controller (split=None) -------------------------------------------------
@pytest.mark.parametrize("names,prefill", [(("pri", "aux"), None),
                                           (("hub", "s1", "s2"), None),
                                           (("hub", "s1", "s2", "pf"), "pf")])
def test_live_controller_streams_and_simplex(names, prefill):
    m = _model()
    reqs = m.requests(n=16, seed=5)
    groups = _groups(C, TDEV, names)
    topo = (C.Topology.pair(groups[0], groups[1], C.ICI_LINK) if len(names) == 2
            else C.Topology.star(groups[0], groups[1:], C.ICI_LINK,
                                 prefill_spoke=prefill))
    rt = C.HeteroRuntime(topo, slots=SLOTS, max_len=MAX_LEN, macro_steps=4,
                         controller=C.SplitRatioController(
                             C.ControllerConfig(update_every=1),
                             n_groups=len(topo.decode_indices())))
    rt.add_task(m.cfg.name, m.cfg, m.params)
    res = rt.serve([ServeRequest(uid=u, prompt=p, max_new=x, task=m.cfg.name)
                    for u, p, x in reqs], wave=4)
    ref = m.per_step(reqs)
    got = {o.uid: o.tokens for o in res.outputs[m.cfg.name]}
    assert sorted(got) == sorted(ref) and len(res.outputs[m.cfg.name]) == len(ref)
    for uid, toks in ref.items():
        np.testing.assert_array_equal(got[uid], toks)
    assert rt.controller.history, "the controller never re-solved"
    for w in res.telemetry["waves"]:
        assert sum(w["counts"]) == w["n"] and min(w["counts"]) >= 0
        assert abs(sum(w["split"]) - 1.0) < 1e-3 and min(w["split"]) >= 0.0
    f = rt.controller.fractions
    assert abs(f.sum() - 1.0) < 1e-9 and (f >= 0).all()


# --- runtime construction errors -----------------------------------------------------
def _rt_errors(mod, dev):
    out = []
    g = _groups(mod, dev, ("pri", "aux", "pf"))
    star = mod.Topology.star(g[0], g[1:], mod.ICI_LINK, prefill_spoke="pf")
    plain = mod.Topology.star(g[0], g[1:], mod.ICI_LINK)
    pure = mod.Topology.star(g[0], g[2:], mod.ICI_LINK, prefill_spoke="pf")
    cases = [
        lambda: mod.HeteroRuntime(plain, controller=mod.SplitRatioController(n_groups=2)),
        lambda: mod.HeteroRuntime(pure, controller=mod.SplitRatioController()),
        lambda: mod.HeteroRuntime(star, macro_steps=0),
        lambda: mod.HeteroRuntime(plain, prefill_router=mod.PrefillRouter()),
        lambda: mod.HeteroRuntime(plain, prefill_pool=0),
        lambda: mod.HeteroRuntime(plain, link_traces={"nope": mod.LinkTrace()}),
        lambda: mod.HeteroRuntime(plain, link_traces={0: mod.LinkTrace()}),
        lambda: mod.HeteroRuntime(plain, group_budgets={"x": mod.GroupBudget()}),
    ]
    for case in cases:
        with pytest.raises(ValueError) as ei:
            case()
        out.append(str(ei.value))
    rt = mod.HeteroRuntime(plain)
    with pytest.raises(RuntimeError) as ei:
        rt.serve([])
    out.append(str(ei.value))
    return out


def test_runtime_errors_equal_to_jax():
    assert _rt_errors(C, TDEV) == _rt_errors(JC, JDEV)


def test_task_routing_errors_and_add_task_copies_params():
    m = _model()
    rt = C.HeteroRuntime(C.Topology.star(*_split(_groups(C, TDEV, ("h", "a", "b"))),
                                         C.ICI_LINK), slots=2, max_len=32)
    spec = rt.add_task("a", m.cfg, m.params)
    # groups on the params' device share them and the decode programs
    engines = list(spec.engines.values())
    table = m.params["embed"]["table"]
    assert all(e.params["embed"]["table"] is table for e in engines)
    assert all(e.step is engines[0].step for e in engines)
    with pytest.raises(ValueError, match="already registered"):
        rt.add_task("a", m.cfg, m.params)
    rt.add_task("b", m.cfg, m.params)
    bad = [ServeRequest(uid=0, prompt=np.ones(PROMPT, np.int32), max_new=2)]
    with pytest.raises(KeyError, match="untagged"):
        rt.serve(bad, warm=False)
    with pytest.raises(KeyError, match="unregistered"):
        rt.serve([dataclasses.replace(bad[0], task="zzz")], warm=False)
    # a group on another device than the params gets its own copy
    meta = C.NodeGroup("m", [torch.device("meta")], C.JETSON_XAVIER)
    rt2 = C.HeteroRuntime(C.Topology.pair(_groups(C, TDEV, ("h",))[0], meta,
                                          C.ICI_LINK), slots=2, max_len=32)
    spec2 = rt2.add_task("a", m.cfg, m.params)
    emb = spec2.engines["m"].params["embed"]["table"]
    assert emb.device.type == "meta"
    assert spec2.engines["h"].params["embed"]["table"] is table
    assert spec2.engines["m"].step is not spec2.engines["h"].step


def test_engine_shares_closures_only_on_same_device_and_kernels():
    m = _model()
    a = ContinuousServingEngine(m.cfg, m.params, slots=2, max_len=32,
                                device="cpu", use_kernels=False)
    same = ContinuousServingEngine(m.cfg, m.params, slots=2, max_len=32,
                                   device="cpu", use_kernels=False, share_from=a)
    other = ContinuousServingEngine(m.cfg, m.params, slots=2, max_len=32,
                                    device="cpu", use_kernels=True, share_from=a)
    assert same.step is a.step and same.prefill is a.prefill
    assert same._loops is a._loops and same._waves is a._waves
    assert other.step is not a.step and other.prefill is not a.prefill
    assert other._loops is not a._loops and other._waves is not a._waves
    assert other._use_kernels and not a._use_kernels


# --- the launcher ----------------------------------------------------------------------
LAUNCH = {
    "continuous-star3": ["--continuous", "--topology", "star", "--nodes", "3"],
    "disaggregated-star4": ["--continuous", "--topology", "star", "--nodes", "4",
                            "--prefill-group", "3", "--prefix-cache-blocks",
                            "64", "--prefill-pool", "2"],
    "link-trace": ["--continuous", "--topology", "star", "--nodes", "3",
                   "--slots", "1", "--link-trace", "4,12,28,12,4"],
    "power-budget": ["--continuous", "--topology", "star", "--nodes", "3",
                     "--power-budget-wh", "5"],
    "frontend": ["--continuous", "--topology", "star", "--nodes", "3",
                 "--frontend"],
    "static-star3": ["--topology", "star", "--nodes", "3", "--split", "auto"],
    "continuous-pair-fixed": ["--continuous", "--split", "0.5",
                              "--telemetry-json", "TELEMETRY"],
}
BASE = ["--device", "cpu", "--reduced", "--requests", "12", "--prompt-len", "8",
        "--max-new", "6"]


@pytest.mark.parametrize("name", sorted(LAUNCH))
def test_launcher_paths_run(name, tmp_path, capsys):
    argv = [str(tmp_path / "tel.json") if a == "TELEMETRY" else a
            for a in LAUNCH[name]]
    out = serve.main(BASE + argv)
    cfg = reduced(get_config("llama3.2-1b"))
    if name == "frontend":
        assert out["refused"] == 0 and len(out["streams"]) == 12
        assert all(len(t) >= 1 for t in out["streams"].values())
        assert sum(t["completed"] for t in out["frontend"]["tenants"].values()) == 12
    elif name.startswith("static"):
        assert out["tokens"].shape == (12, 6) and len(out["f_star"]) == 3
        assert abs(sum(out["split"]) - 1.0) < 1e-6
        assert sum(out["n_group"]) == 12
        assert set(out["compression_by_group"]) <= {"auxiliary1", "auxiliary2"}
    else:
        outs = out.outputs[cfg.name]
        assert sorted(o.uid for o in outs) == list(range(12))
        tot = out.telemetry["totals"]
        assert tot["requests"] == 12 and tot["tokens"] == sum(len(o.tokens)
                                                              for o in outs)
        if name == "disaggregated-star4":
            assert out.telemetry["prefill_group"] == "auxiliary3"
            assert tot["prefill_offloaded"] > 0
        if name == "link-trace":
            assert tot["mobility_latched"] >= 1
        if name == "continuous-pair-fixed":
            assert json.loads((tmp_path / "tel.json").read_text())["totals"] \
                == json.loads(out.to_json())["totals"]


ERRORS = [["--prefill-group", "1"], ["--prefix-cache-blocks", "8"],
          ["--prefill-pool", "2"], ["--link-trace", "4,5"],
          ["--continuous", "--mobility-beta", "3"], ["--wave-steps", "2"],
          ["--frontend"], ["--power-budget-wh", "5"]]


def _stderr_of(fn, argv):
    buf = io.StringIO()
    with redirect_stderr(buf), pytest.raises(SystemExit) as ei:
        fn(argv)
    assert ei.value.code == 2
    return buf.getvalue().strip().splitlines()[-1]


def _jax_main(argv):
    from repro.launch import serve as jserve
    old = sys.argv
    sys.argv = ["serve.py", "--reduced"] + argv
    try:
        jserve.main()
    finally:
        sys.argv = old


@pytest.mark.parametrize("argv", ERRORS, ids=[" ".join(a) for a in ERRORS])
def test_launcher_flag_errors_read_as_jax(argv, capsys):
    got = _stderr_of(serve.main, ["--device", "cpu", "--reduced"] + argv)
    want = _stderr_of(_jax_main, argv)
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]


def _stdout_of(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(argv)
    return buf.getvalue().splitlines()


def test_launcher_kv_int8_not_ported():
    """--kv-int8 (once refused as not ported, hence the name) runs the
    static path and prints what JAX's launcher prints: the arch line with
    kv=int8 (the port adds its device) and the local-only output shape."""
    argv = ["--kv-int8", "--split", "none", "--requests", "4",
            "--prompt-len", "8", "--max-new", "4"]
    got = _stdout_of(serve.main, ["--device", "cpu", "--reduced"] + argv)
    want = _stdout_of(_jax_main, argv)
    assert want[0] == "arch=llama3.2-1b (reduced) kv=int8 topology=pair/2"
    assert got[0] == want[0] + " device=cpu"
    assert got[-1].split(" in ")[0] == want[-1].split(" in ")[0] \
        == "local-only: (4, 4)"
