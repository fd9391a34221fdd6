"""The port's own spans (``repro_torch.tracing``) over a small pair-topology
``HeteroRuntime.serve`` on the CPU.

Off (the default), no ``record_function`` range is entered and nothing is
kept.  On, every layer boundary opens its span under the one the table in
``tracing.SPANS`` puts it under, each request is prefilled once under a
span that carries its uid, the macro-step and decode-step spans of each
group agree with the telemetry's launch counts, each request's prefill
lies between the opening of its ``serve`` call and its first
``on_tokens`` call, and token streams and integer telemetry are the same
as with recording off.  A span's
in-memory start lies within 1 ms of its ``torch.profiler`` event's start.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as C  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import ServeRequest  # noqa: E402

K = 4
MAX_NEWS = (1, 4, 7, 3, 6, 2)
SCHEDULES = {
    "overlapped": {},
    "overlapped_wave2": {"wave_steps": 2},
    "boundary": {"overlap_admission": False},
    "per_step": {"macro_steps": 0},
}
# the span each span opens under, per schedule (None: the outermost)
PARENTS = {
    "runtime.serve": {None},
    "runtime.wave": {"runtime.serve"},
    "runtime.group": {"runtime.wave"},
    "engine.run": {"runtime.group"},
    "engine.boundary": {"engine.run"},
    "engine.dispatch": {"engine.run"},
    "engine.topup": {"engine.run"},
    "engine.await": {"engine.run"},
    "engine.consume": {"engine.run"},
    "engine.per_step": {"engine.run"},
    "engine.prefill": {"engine.boundary", "engine.topup"},
    "engine.splice": {"engine.boundary"},
    "engine.macro_step": {"engine.dispatch"},
    "model.prefill": {"engine.prefill"},
    "attention.full": {"model.prefill"},
    "model.decode_step": {"engine.macro_step", "engine.per_step"},
    "kernels.decode_attention": {"model.decode_step"},
    "attention.mla_prefill": {"model.prefill"},
    "attention.mla_decode": {"model.decode_step"},
    "moe.route": {"model.prefill", "model.decode_step"},
    "moe.experts": {"model.prefill", "model.decode_step"},
    "moe.shared": {"model.prefill", "model.decode_step"},
}
FUSED = {"engine.dispatch", "engine.await", "engine.consume",
         "engine.macro_step"}
# an MLAConfig's layers' spans (tests/test_torch_mla.py): llama runs none
MLA_SPANS = {"attention.mla_prefill", "attention.mla_decode", "moe.route",
             "moe.experts", "moe.shared"}


class _Model:
    def __init__(self):
        self.cfg = reduced(get_config("llama3.2-1b"))
        self.params = M.init_params(self.cfg, 0, device="cpu")
        rng = np.random.default_rng(0)
        self.prompts = rng.integers(0, self.cfg.vocab_size,
                                    (len(MAX_NEWS), 8)).astype(np.int32)

    def requests(self):
        return [ServeRequest(uid=i, prompt=self.prompts[i], max_new=n,
                             task=self.cfg.name)
                for i, n in enumerate(MAX_NEWS)]

    def runtime(self, **kw):
        groups = [C.NodeGroup(n, [torch.device("cpu")], p) for n, p in
                  (("pri", C.JETSON_NANO), ("aux", C.JETSON_XAVIER))]
        topo = C.Topology.pair(groups[0], groups[1], C.ICI_LINK)
        rt_kw = dict(slots=2, max_len=32, macro_steps=K)
        rt_kw.update(kw)
        rt = C.HeteroRuntime(topo, **rt_kw)
        rt.add_task(self.cfg.name, self.cfg, self.params)
        rt.warmup(self.requests()[1:2])
        return rt


@pytest.fixture(scope="module")
def model():
    return _Model()


def _serve(model, sched, record: bool):
    """One serve of the six requests at split 0.5: (result, recording or
    None, each uid's first on_tokens time)."""
    rt = model.runtime(**SCHEDULES[sched])
    landed = {}

    def on_tokens(uid, start, toks):
        landed.setdefault(uid, time.time_ns())

    if not record:
        res = rt.serve(model.requests(), split=0.5, warm=False,
                       on_tokens=on_tokens)
        return res, None, landed
    with tracing.recording() as rec:
        res = rt.serve(model.requests(), split=0.5, warm=False,
                       on_tokens=on_tokens)
    return res, rec, landed


_RUNS = {}


def _run(model, sched, record=True):
    key = (sched, record)
    if key not in _RUNS:
        _RUNS[key] = _serve(model, sched, record)
    return _RUNS[key]


def _discrete(tree):
    """The telemetry with every float (walls, rates, headrooms) left out."""
    if isinstance(tree, dict):
        return {k: _discrete(v) for k, v in tree.items()
                if not isinstance(v, float)}
    if isinstance(tree, (list, tuple)):
        return [_discrete(v) for v in tree if not isinstance(v, float)]
    return tree


def _group_of(rec, r):
    """The group of the ``runtime.group`` span up ``r``'s parent chain."""
    while r.name != "runtime.group":
        r = rec.spans[r.parent]
    return r.attrs["group"]


def _spans_per_group(rec, name):
    out = {}
    for r in rec.named(name):
        g = _group_of(rec, r)
        out[g] = out.get(g, 0) + 1
    return out


def _per_group(res, key):
    out = {}
    for w in res.telemetry["waves"]:
        for name, g in w["per_group"].items():
            out[name] = out.get(name, 0) + g[key]
    return out


class _CountingRF:
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return None


def test_off_enters_no_record_function_and_keeps_nothing(model, monkeypatch):
    _CountingRF.entered = 0
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRF)
    res, _, _ = _serve(model, "overlapped", record=False)
    assert res.telemetry["totals"]["wave_launches"] > 0
    assert _CountingRF.entered == 0
    assert tracing._recording is None
    assert tracing.span("engine.run") is tracing.span("model.prefill")
    assert tracing.current() is None
    with tracing.timed("engine.dispatch") as sp:
        pass
    assert sp.seconds >= 0.0
    # on, the same patch sees every span enter a range
    with tracing.recording() as rec:
        with tracing.span("engine.run"):
            pass
    assert _CountingRF.entered == 1 and len(rec.spans) == 1


def test_recording_is_not_reentrant():
    with tracing.recording():
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
    assert tracing._recording is None


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_span_names_and_nesting_as_tabled(model, sched):
    _, rec, _ = _run(model, sched)
    names = {r.name for r in rec.spans}
    assert names <= set(tracing.SPANS) == set(PARENTS)
    want = set(PARENTS) - {"engine.per_step"} - MLA_SPANS
    if sched == "per_step":
        want = want - FUSED - {"engine.topup"} | {"engine.per_step"}
    elif sched == "boundary":
        want = want - {"engine.topup"}
    assert names == want
    for r in rec.spans:
        parent = None if r.parent is None else rec.spans[r.parent].name
        assert parent in PARENTS[r.name], (r.name, parent)
        assert 0 < r.start_ns <= r.end_ns
        if r.parent is not None:
            p = rec.spans[r.parent]
            if p.thread == r.thread:      # nested in time on one thread
                assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert [r.attrs["wave"] for r in rec.named("runtime.wave")] == \
        list(range(len(rec.named("runtime.wave"))))
    assert {r.attrs["group"] for r in rec.named("runtime.group")} == \
        {"pri", "aux"}


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_every_request_prefilled_once_under_its_uid(model, sched):
    _, rec, _ = _run(model, sched)
    pre = rec.named("engine.prefill")
    assert sorted(r.uid for r in pre) == list(range(len(MAX_NEWS)))
    exposed = sum(r.attrs["exposed"] for r in pre)
    # the top-up's prefills are the overlapped ones; the rest are exposed
    assert len(pre) - exposed == sum(
        rec.spans[r.parent].name == "engine.topup" for r in pre)
    if sched in ("boundary", "per_step"):
        assert exposed == len(pre)
    for r in rec.named("model.prefill"):
        assert rec.spans[r.parent].uid is not None


@pytest.mark.parametrize("sched", sorted(set(SCHEDULES) - {"per_step"}))
def test_decode_steps_and_macro_steps_match_the_telemetry(model, sched):
    res, rec, _ = _run(model, sched)
    tel = res.telemetry
    W = tel["wave_steps"]
    launches = _per_group(res, "wave_launches")
    assert sum(launches.values()) == tel["totals"]["wave_launches"] > 0
    assert len(rec.named("engine.macro_step")) == sum(launches.values())
    assert len(rec.named("model.decode_step")) == \
        sum(launches.values()) * W * K
    assert _spans_per_group(rec, "engine.macro_step") == launches
    assert _spans_per_group(rec, "model.decode_step") == \
        {g: n * W * K for g, n in launches.items()}


def test_per_step_path_counts_its_decode_steps(model):
    _, rec, _ = _run(model, "per_step")
    steps = rec.named("engine.per_step")
    assert len(steps) == len(rec.named("model.decode_step")) > 0
    assert _spans_per_group(rec, "model.decode_step") == \
        _spans_per_group(rec, "engine.per_step")


@pytest.mark.parametrize("sched", ["overlapped", "boundary"])
def test_prefill_between_arrival_and_first_on_tokens(model, sched):
    """A request arrives when its ``runtime.serve`` span opens; its
    prefill starts after that and ends before its first token reaches
    ``on_tokens``."""
    _, rec, landed = _run(model, sched)
    (serve,) = rec.named("runtime.serve")
    pre = {r.uid: r for r in rec.named("engine.prefill")}
    assert sorted(pre) == sorted(landed) == list(range(len(MAX_NEWS)))
    for uid, r in pre.items():
        assert serve.start_ns <= r.start_ns <= r.end_ns <= landed[uid]


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_streams_and_telemetry_same_on_and_off(model, sched):
    on, _, _ = _run(model, sched)
    off, _, _ = _run(model, sched, record=False)
    for task in off.outputs:
        assert [(o.uid, o.tokens.tolist()) for o in on.outputs[task]] == \
            [(o.uid, o.tokens.tolist()) for o in off.outputs[task]]
    assert _discrete(on.telemetry) == _discrete(off.telemetry)


def test_buckets_add_up_their_spans(model):
    res, rec, _ = _run(model, "overlapped")
    tot = res.telemetry["totals"]
    for bucket, name in (("t_dispatch_s", "engine.dispatch"),
                         ("t_await_s", "engine.await"),
                         ("t_slot_write_s", "engine.splice"),
                         ("t_prefill_overlap_s", "engine.topup")):
        want = sum(r.end_ns - r.start_ns for r in rec.named(name)) * 1e-9
        assert tot[bucket] == pytest.approx(want, rel=1e-9, abs=1e-12)
    walls = [w["wall_s"] for w in res.telemetry["waves"]]
    assert walls == pytest.approx([(r.end_ns - r.start_ns) * 1e-9
                                   for r in rec.named("runtime.wave")],
                                  rel=1e-9)


def test_span_start_within_1ms_of_its_profiler_event():
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording() as rec:
            for i in range(20):
                with tracing.span("engine.dispatch", i):
                    x = x @ x / 64
    events = sorted((e.start_ns() for e in prof.profiler.kineto_results
                     .events() if e.name() == tracing.PREFIX
                     + "engine.dispatch"))
    mine = sorted(r.start_ns for r in rec.spans)
    assert len(events) == len(mine) == 20
    for a, b in zip(mine, events):
        assert abs(b - a) < 1_000_000
