"""Each metric's arithmetic on a hand-built run record and a synthetic
device timeline; the percentiles with a request censored at the close;
the yardstick's formulas against the port's and against hand counts."""
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, trace, yardstick
from portbench.families import common, dense_gqa

PB = Path(__file__).resolve().parent.parent

DENSE = dict(num_layers=2, d_model=8, num_heads=4, num_kv_heads=2,
             head_dim=2, d_ff=16, vocab_size=10, dtype="bfloat16",
             norm_type="layernorm", tie_embeddings=False)


def _read(name, run):
    return harness.reader(PB, name).read(run)


def _run():
    run = harness.Run(cell={"name": "x"}, config=DENSE,
                      sizes=common.sizes(DENSE), family=dense_gqa, mix={},
                      seconds=0.5, t0=0.0, t_end=1.2)
    R = harness.RequestRecord
    run.requests = {
        1: R(1, 0, due=0.0, prompt_len=6, max_new=12,
             landings=[(0.5, 1), (1.0, 8), (1.5, 3)]),
        2: R(2, 0, due=0.0, prompt_len=6, max_new=4),
        3: R(3, 1, due=1.3, prompt_len=6, max_new=2, landings=[(1.4, 1)]),
    }
    for r in run.requests.values():
        r.tokens = [0] * r.max_new
    run.traced_batches = {0, 1}
    run.telemetry = [{"macro_steps": 8, "wave_steps": 1, "waves": [{
        "wall_s": 10.0, "n": 3, "admission_stalls": 2, "per_group": {
            "primary": {"wall_s": 6.0, "wave_launches": 10,
                        "t_per_macro_step_s": 0.4},
            "auxiliary": {"wall_s": 3.5, "wave_launches": 30,
                          "t_per_macro_step_s": 0.08}}}]}]
    return run


def test_end_to_end_metrics_with_a_censored_request():
    run = _run()
    assert _read("tokens_per_s", run) == pytest.approx(9 / 1.2)
    # r1: 0.5 s; r2 never landed: censored at the close, 1.2 s; r3 was due
    # after the close.  Linear between ranks: 0.5 + 0.9 * 0.7
    assert _read("ttft_p90_ms", run) == pytest.approx(1e3 * (0.5 + 0.9 * 0.7))
    # r1 landed 9 tokens in the window, the last at 1.0 s
    assert _read("tpot_p90_ms.host", run) == pytest.approx(1e3 * 0.5 / 8)
    run.setup_s = 31.5
    assert _read("setup_s", run) == 31.5


def test_groups_recorded_from_the_engine_that_runs_each_request():
    class Engine:
        def run(self, reqs, on_tokens=None):
            return [r.uid for r in reqs], on_tokens

    engines = {"hub": Engine(), "spoke": Engine()}
    runtime = SimpleNamespace(tasks={"t": SimpleNamespace(engines=engines)})
    recs = {u: harness.RequestRecord(u, 0) for u in (1, 2, 3)}
    harness._record_groups(runtime, "t", recs)
    assert engines["spoke"].run([SimpleNamespace(uid=2)], on_tokens=7) \
        == ([2], 7)
    # a patch put on the class later (a span, a planted fault) still runs
    Engine.run = lambda self, reqs, on_tokens=None: "patched"
    assert engines["hub"].run([SimpleNamespace(uid=1),
                               SimpleNamespace(uid=3),
                               SimpleNamespace(uid=99)]) == "patched"
    assert {u: r.group for u, r in recs.items()} == {1: "hub", 2: "spoke",
                                                     3: "hub"}


def test_percentile_rank_interpolation():
    assert harness.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 90) \
        == pytest.approx(9.1)
    assert harness.percentile([], 90) is None


def test_runtime_and_engine_metrics():
    run = _run()
    assert _read("runtime_host_ms_per_wave", run) == pytest.approx(500.0)
    assert _read("engine_ms_per_decode_step", run) == pytest.approx(
        1e3 * (0.4 * 10 + 0.08 * 30) / (40 * 8))
    assert _read("engine_stalls_per_request", run) == pytest.approx(2 / 3)


def _brute_dense(c, P, n):
    W = (c.d_model * c.num_heads * c.head_dim
         + 2 * c.d_model * c.num_kv_heads * c.head_dim
         + c.num_heads * c.head_dim * c.d_model + 2 * c.d_model * c.d_ff)
    head = 2 * c.vocab_size * c.d_model
    total = head
    for p in range(P):
        total += c.num_layers * (2 * W + 4 * c.num_heads * c.head_dim * (p + 1))
    for j in range(1, n):
        total += c.num_layers * (2 * W + 4 * c.num_heads * c.head_dim
                                 * (P + j)) + head
    return total


def test_model_mfu_counts_by_hand():
    run = _run()
    c = run.sizes
    flops = sum(_brute_dense(c, 6, n) for n in (12, 4, 2))
    assert dense_gqa.request_flops(c, 6, 12) == _brute_dense(c, 6, 12)
    assert _read("model_mfu", run) == pytest.approx(
        100 * flops / (1.2 * 989e12))


@pytest.mark.parametrize("B,H,Hkv,dh,rows,esize", [
    (1, 48, 8, 128, 2049, 2), (32, 48, 8, 128, 65536, 2), (3, 8, 1, 64, 7, 4)])
def test_frozen_decode_attention_cost_equals_the_ports(B, H, Hkv, dh, rows,
                                                       esize):
    from repro_torch.kernels import costs
    assert yardstick.decode_attention_cost(B, H, Hkv, dh, rows, esize) \
        == costs.decode_attention(B, H, Hkv, dh, rows, esize)


def test_roofline_seconds_takes_the_larger_term():
    assert yardstick.roofline_seconds(989e12, 1.0) == pytest.approx(1.0)
    assert yardstick.roofline_seconds(1.0, 6.7e12) == pytest.approx(2.0)


class _Ev:
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def __init__(self, name, t0_us, t1_us, dev="cpu", tid=0, stream=0,
                 ua=False):
        self._n = name
        self._t0, self._d = int(t0_us * 1e3), int((t1_us - t0_us) * 1e3)
        self._dev = self.CUDA if dev == "cuda" else self.CPU
        self._tid, self._stream, self._ua = tid, stream, ua

    def name(self): return self._n
    def start_ns(self): return self._t0
    def duration_ns(self): return self._d
    def device_type(self): return self._dev
    def is_user_annotation(self): return self._ua
    def start_thread_id(self): return self._tid
    def device_resource_id(self): return self._stream


def _timeline():
    E = _Ev
    return [
        E("portbench.decode_attend", 100, 200, tid=7, ua=True),
        E("portbench.prefill", 250, 350, tid=1, ua=True),
        E("cudaLaunchKernel", 120, 130, tid=7),
        # the device range the profiler lays over the span's operations
        E("portbench.decode_attend", 150, 185, "cuda", stream=7, ua=True),
        E("k_in", 150, 170, "cuda", stream=7),
        E("k_direct", 180, 185, "cuda", stream=7),
        E("k_other_stream", 160, 175, "cuda", stream=9),
        E("k_after", 400, 500, "cuda", stream=7),
        E("k_after", 600, 610, "cuda", stream=7),
    ]


def test_trace_reduction_on_a_synthetic_timeline():
    t = trace.reduce(_timeline(), window_s=1e-3, spans=("decode_attend",
                                                        "prefill"))
    # union: 150-175, 180-185, 400-500, 600-610
    assert t.busy_s == pytest.approx((25 + 5 + 100 + 10) * 1e-6)
    # the span's stream inside its device range; not the other stream
    assert t.span_device_s["decode_attend"] == pytest.approx(25e-6)
    assert t.span_calls == {"decode_attend": 1, "prefill": 1}
    assert t.device_ops[0] == ("k_after", pytest.approx(110e-6))
    assert t.idle_gaps[0] == ("prefill (thread 1)", pytest.approx(215e-6))
    assert t.idle_gaps[1] == ("outside every span", pytest.approx(100e-6))
    assert t.idle_gaps[-1][1] == pytest.approx((5 + 215 + 100) * 1e-6)
    run = _run()
    run.trace = t
    assert _read("device_idle_share", run) == pytest.approx(
        100 * (1 - 140e-6 / 1e-3))


def test_rooflines_from_the_span_and_the_yardstick():
    run = _run()
    run.trace = trace.Trace(window_s=1.0, busy_s=0.5, device_ops=[],
                            idle_gaps=[], span_device_s={"decode_attend": 2e-6},
                            span_calls={"decode_attend": 3})
    c = run.sizes
    least = 0.0
    for r in run.requests.values():
        for j in range(1, r.max_new):
            rows = 6 + j
            by = 2 * rows * 2 * 2 * 2 + 2 * 4 * 2 * 2 + 4
            least += 2 * max(4 * 4 * rows * 2 / 989e12, by / 3.35e12)
    assert _read("decode_attention_roofline", run) == pytest.approx(
        100 * least / 2e-6)


def test_rooflines_count_the_traced_batch_only():
    run = _run()
    run.traced_batches = {1}
    run.trace = trace.Trace(window_s=1.0, busy_s=0.5, device_ops=[],
                            idle_gaps=[], span_device_s={"decode_attend": 2e-6},
                            span_calls={"decode_attend": 3})
    c = run.sizes
    by = 2 * 7 * 2 * 2 * 2 + 2 * 4 * 2 * 2 + 4           # r3: one step
    least = 2 * max(4 * 4 * 7 * 2 / 989e12, by / 3.35e12)
    assert _read("decode_attention_roofline", run) == pytest.approx(
        100 * least / 2e-6)


def test_missing_span_reads_nothing_never_zero():
    run = _run()
    assert _read("decode_attention_roofline", run) is None
    run.trace = trace.Trace(window_s=1.0, busy_s=0.0, device_ops=[],
                            idle_gaps=[])
    assert _read("decode_attention_roofline", run) is None
    assert _read("device_idle_share", run) is None
    found, restore = trace.wrap({"gone": ("repro_torch.models.attention",
                                          "no_such_function")})
    assert found == set()
    restore()


def test_every_metric_has_a_reader_that_agrees_with_the_benchmark():
    import json
    bench = json.loads((PB.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        r = harness.reader(PB, m["name"])
        assert (r.UNIT, r.SOURCE) == (m["unit"], m["source"]), m["name"]
        if "layer" in m:
            assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"]), m["name"]
