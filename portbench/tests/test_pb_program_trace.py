"""The reduction of the program's own spans (``program_trace.reduce``) and
the readers that read it, on a synthetic timeline; the benchmark's old
reduction and readers unchanged by the program's events; a CPU run with
the program's recording on through ``program_trace.run_traced``."""
from pathlib import Path

import pytest
import torch

import pb_small
from portbench import harness, program_trace, trace
from portbench.families import common, dense_gqa
from repro_torch import tracing

PB = Path(__file__).resolve().parent.parent
DENSE = dict(num_layers=2, d_model=8, num_heads=4, num_kv_heads=2,
             head_dim=2, d_ff=16, vocab_size=10, dtype="bfloat16",
             norm_type="layernorm", tie_embeddings=False)
OLD_READERS = ("tokens_per_s", "ttft_p90_ms", "runtime_host_ms_per_wave",
               "engine_ms_per_decode_step", "engine_stalls_per_request",
               "tpot_p90_ms.host", "model_mfu", "decode_attention_roofline",
               "device_idle_share")


class _Ev:
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def __init__(self, name, t0, t1, dev="cpu", tid=0, stream=0, ua=False,
                 corr=0):
        self._n, self._t0, self._d = name, int(t0), int(t1 - t0)
        self._dev = self.CUDA if dev == "cuda" else self.CPU
        self._tid, self._stream, self._ua = tid, stream, ua
        self._corr = corr

    def name(self): return self._n
    def start_ns(self): return self._t0
    def duration_ns(self): return self._d
    def device_type(self): return self._dev
    def is_user_annotation(self): return self._ua
    # as the profiler has it: a host event's resource is its system
    # thread, and a launch's start_thread_id is not its thread's
    def start_thread_id(self): return 1
    def device_resource_id(self):
        return self._stream if self._dev == self.CUDA else self._tid
    def correlation_id(self): return self._corr


def _host(name, t0, t1, tid):
    return _Ev("heteroedge." + name, t0, t1, tid=tid, ua=True)


def _dev_range(name, t0, t1, stream=7):
    return _Ev("heteroedge." + name, t0, t1, "cuda", stream=stream, ua=True)


def _kernel(name, t0, t1, corr, stream=7):
    return _Ev(name, t0, t1, "cuda", stream=stream, corr=corr)


def _launch(t, tid, corr):
    return _Ev("cudaLaunchKernel", t, t + 3, tid=tid, corr=corr)


def _program_events():
    """Thread 1 prefills, thread 2 decodes; six kernels, one without a
    launch event, one launched from a thread with no span."""
    return [
        _host("engine.prefill", 100, 300, 1),
        _host("model.prefill", 110, 290, 1),
        _host("attention.full", 150, 200, 1),
        _host("engine.macro_step", 400, 700, 2),
        _host("model.decode_step", 410, 550, 2),
        _host("kernels.decode_attention", 420, 440, 2),
        _host("model.decode_step", 560, 690, 2),
        _launch(155, 1, 1), _launch(240, 1, 2), _launch(425, 2, 3),
        _launch(570, 2, 4), _launch(880, 3, 6),
        _dev_range("model.prefill", 160, 260),
        _dev_range("attention.full", 160, 180),
        _dev_range("model.decode_step", 430, 435),
        _dev_range("kernels.decode_attention", 430, 435),
        _dev_range("model.decode_step", 600, 650),
        _kernel("k1", 160, 180, 1), _kernel("k2", 250, 260, 2),
        _kernel("k3", 430, 435, 3), _kernel("k4", 600, 650, 4),
        _kernel("k5", 720, 730, 5), _kernel("k6", 900, 950, 6, stream=9),
    ]


def test_reduce_charges_every_gap_and_sums_exactly():
    p = program_trace.reduce(_program_events(), None, 50, 1000)
    busy = 20 + 10 + 5 + 50 + 10 + 50
    assert p.idle_s == pytest.approx((950 - busy) * 1e-9)
    ns = {k: round(v * 1e9) for k, v in p.idle_by_program_span.items()}
    # [50,160) ends with k1, launched by thread 1 inside attention.full;
    # [180,250) k2: thread 1 back in model.prefill at 250; [260,430) k3:
    # thread 2 in kernels.decode_attention; [435,600) k4: the second
    # decode step; [650,720) k5 has no launch: at its middle thread 2 is
    # in the second decode step (the fallback); [730,900) k6 came from a
    # thread with no span and no span is open at its middle; [950,1000)
    # ends with nothing: no span at its middle
    assert ns == {"attention.full": 110, "model.prefill": 70,
                  "kernels.decode_attention": 170,
                  "model.decode_step": 165 + 70,
                  program_trace.OUTSIDE: 170 + 50}
    assert sum(ns.values()) == 950 - busy
    assert round(p.idle_fallback_s * 1e9) == 70
    under = {k: round(v * 1e9) for k, v in p.idle_under.items()}
    assert under["engine.prefill"] == 180
    assert under["engine.macro_step"] == 170 + 235
    assert under["model.decode_step"] == 170 + 235
    assert (p.launch_events, p.launches_found, p.device_ops_total) == (5, 5, 6)
    assert p.device_s["model.prefill"] == pytest.approx(30e-9)
    assert p.device_ops == {"model.prefill": 2, "attention.full": 1,
                            "model.decode_step": 2,
                            "kernels.decode_attention": 1}
    assert p.host_calls["model.decode_step"] == 2


def test_reduce_with_no_device_operation_charges_the_window():
    p = program_trace.reduce([_host("engine.run", 0, 500, 1)], None, 100, 400)
    assert p.idle_by_program_span == {"engine.run": pytest.approx(300e-9)}
    assert p.idle_fallback_s == pytest.approx(300e-9)


def _records():
    """Two ``runtime.serve`` calls (at 0 and 5 ms): uids 1 and 2 in the
    first, their prefills under its engine run, uid 1 prefilled twice (a
    re-queue); uid 3 in the second."""
    rec = tracing.Recording()

    def add(name, uid, parent, start):
        rec.spans.append(tracing.SpanRecord(
            len(rec.spans), name, uid, parent, 1, start, start + 1000))
        return len(rec.spans) - 1

    first = add("runtime.serve", None, None, 0)
    run = add("engine.run", None, first, 1000)
    second = add("runtime.serve", None, None, 5_000_000)
    add("engine.prefill", 1, run, 10_000_000)
    add("engine.prefill", 2, run, 30_000_000)
    add("engine.prefill", 3, second, 9_000_000)
    add("engine.prefill", 1, run, 40_000_000)
    return rec


def _run(program=None):
    run = harness.Run(cell={"name": "x"}, config=DENSE,
                      sizes=common.sizes(DENSE), family=dense_gqa, mix={},
                      seconds=0.5, t0=0.0, t_end=1.2)
    R = harness.RequestRecord
    run.requests = {
        1: R(1, 0, due=0.0, prompt_len=6, max_new=12,
             landings=[(0.5, 1), (1.0, 8), (1.5, 3)]),
        2: R(2, 0, due=0.0, prompt_len=6, max_new=4),
    }
    for r in run.requests.values():
        r.tokens = [0] * r.max_new
    run.traced_batches = {0}
    run.telemetry = [{"macro_steps": 8, "wave_steps": 1, "waves": [{
        "wall_s": 10.0, "n": 2, "admission_stalls": 1, "per_group": {
            "primary": {"wall_s": 6.0, "wave_launches": 10,
                        "t_per_macro_step_s": 0.4}}}]}]
    if program is not None:
        run.program = program
    return run


def _read(name, run):
    return harness.reader(PB, name).read(run)


def test_each_new_reader_on_the_synthetic_timeline():
    p = program_trace.reduce(_program_events(), _records(), 50, 1000)
    run = _run(p)
    assert _read("decode_step_ms.device", run) == pytest.approx(
        1e3 * 55e-9 / 2)
    assert _read("launches_per_decode_step", run) == 1.0
    assert _read("prefill_ms_per_request.device", run) == pytest.approx(
        1e3 * 30e-9)
    assert _read("prefill_attention_ms_per_request.device", run) == \
        pytest.approx(1e3 * 20e-9)
    assert _read("device_idle_share.prefill", run) == pytest.approx(
        100 * 180 / 950)
    assert _read("device_idle_share.decode", run) == pytest.approx(
        100 * 405 / 950)
    # waits 10, 30 and 4 ms; p90 linear between ranks: 10 + 0.8 * 20
    assert _read("queue_wait_p90_ms", run) == pytest.approx(26.0)
    # the program's span reads the old metric's formula over its own time
    run.trace = trace.Trace(window_s=1.0, busy_s=0.5, device_ops=[],
                            idle_gaps=[],
                            span_device_s={"decode_attend": 5e-9},
                            span_calls={"decode_attend": 1})
    assert _read("decode_attention_roofline.program", run) == pytest.approx(
        _read("decode_attention_roofline", run))


def test_new_readers_read_nothing_without_the_program():
    run = _run()
    for name in program_trace.METRICS:
        assert _read(name, run) is None, name
    run = _run(program_trace.reduce([], None, 0, 100))
    for name in program_trace.METRICS:
        assert _read(name, run) is None, name


def _old_events():
    E = _Ev
    return [
        E("portbench.decode_attend", 100, 200, tid=7, ua=True),
        E("portbench.prefill", 250, 350, tid=1, ua=True),
        E("cudaLaunchKernel", 120, 130, tid=7, corr=1),
        E("portbench.decode_attend", 150, 185, "cuda", stream=7, ua=True),
        _kernel("k_in", 150, 170, 1), _kernel("k_direct", 180, 185, 2),
        _kernel("k_other_stream", 160, 175, 3, stream=9),
        _kernel("k_after", 400, 500, 4), _kernel("k_after", 600, 610, 5),
    ]


def test_program_events_leave_the_old_reduction_and_readers_unchanged():
    """The same device operations and launches, with and without the
    program's host spans and device ranges: every field of the old
    ``Trace`` and every old reader's value the same."""
    spans = ("decode_attend", "prefill")
    new = trace.reduce(_old_events() + _program_events(), 1e-3, spans=spans)
    plain = trace.reduce(_old_events() + [
        e for e in _program_events() if not e.name().startswith(
            "heteroedge.")], 1e-3, spans=spans)
    assert new == plain
    assert new.span_calls == {"decode_attend": 1, "prefill": 1}
    for name in OLD_READERS:
        a, b = _run(), _run()
        a.trace, b.trace = plain, new
        assert _read(name, a) == _read(name, b), name


def test_wrap_still_finds_every_benchmark_span():
    roof = harness.reader(PB, "decode_attention_roofline")
    targets = dict(harness.HOST_SPANS, **{roof.SPAN[1]: roof.SPAN})
    found, restore = trace.wrap(targets)
    try:
        assert found == set(targets)
    finally:
        restore()


def test_cpu_run_with_the_programs_recording(root):
    from portbench import trace as trace_mod
    recorder, compute = trace_mod.Recorder, harness.compute_metrics
    cell = "nemotron-4-15b.docqa"
    torch.manual_seed(0)
    res = program_trace.run_traced(
        root, cell, 12345678901, 0.3, device="cpu", look_for_chip=False,
        mix_override=pb_small.MIX, config_override=pb_small.CONFIGS[cell],
        limits_override=pb_small.LIMITS)
    assert (trace_mod.Recorder, harness.compute_metrics) == (recorder,
                                                             compute)
    assert res["correct"]
    p = res["program"]
    # the traced batch: one wave of the runtime, two groups of slots
    assert p["host_calls"]["engine.prefill"] == 2 * pb_small.MIX["slots"]
    assert p["host_calls"]["runtime.serve"] == 1
    assert p["clock_offset_us"]["max"] < 1000
    assert res["metrics"]["queue_wait_p90_ms"]["value"] >= 0.0
    # K = 8 decode steps a launch (wave_steps 1)
    assert p["host_calls"]["model.decode_step"] \
        == 8 * p["host_calls"]["engine.macro_step"] > 0
    # no device: the whole window is idle and charged, and the old
    # readers' line is unchanged in form
    assert sum(p["idle_by_program_span"].values()) == pytest.approx(
        p["idle_s"])
    assert {"device_idle_share", "decode_attention_roofline"} \
        .isdisjoint(res["metrics"])
