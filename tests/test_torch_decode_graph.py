"""The fused decode loop's CUDA graphs (``serving/decode_graph.py``) on the
CPU.

A capture needs a card: ``tools/check_decode_graph.py`` runs the cells'
configurations there, graphs against the eager loop.  Here: the refusal's
reasons; the break helper at both decode-attention call sites (a counting
stand-in for ``models.attention.decode_attend`` / ``mla_decode_attend``
sees every attention layer's call of every step, through the eager loop
and through the graphs' replays with the capture backend stood in by plain
closures); the int8 cache's breaks holding no f32 copy of a layer's
cache; the loop's one cache, which the engines that share the loop run
on in turn; the launch counts' bookkeeping, with another thread launching
during a capture; the eager loop bit for bit against the loop as it was
before the graphs; the engine's counters."""
import contextlib
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core.offload import tree_leaves  # noqa: E402
from repro_torch.kernels import costs, ops  # noqa: E402
from repro_torch.models import attention, sharding  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import decode_graph, engine  # noqa: E402

K, B, MAX_LEN, PROMPT = 4, 3, 24, 6
# a small MLAConfig: a dense layer, then two MoE layers
MLA = dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
           head_dim=24, d_ff=24, vocab_size=512, num_experts=8,
           experts_per_token=3, num_shared_experts=2, kv_lora_rank=32,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           first_k_dense=1, dense_d_ff=96, dtype="float32")
# dense GQA, latent attention, SSM (no attention), audio (self + cross),
# dense GQA over an int8 cache
INT8 = "llama3.2-1b-int8"
ARCHS = ["llama3.2-1b", "moonlight-16b-a3b", "falcon-mamba-7b",
         "seamless-m4t-medium", INT8]


def _cfg(arch):
    if arch == "moonlight-16b-a3b":
        return dataclasses.replace(get_config(arch), **MLA)
    if arch == INT8:
        return dataclasses.replace(reduced(get_config("llama3.2-1b")),
                                   kv_quant="int8")
    return reduced(get_config(arch))


def _attention_layers(cache) -> int:
    """The decode-attention calls of one step: the layers of every K or
    latent leaf of the cache (self and cross alike)."""
    if isinstance(cache, dict):
        return sum(v.shape[0] if k in ("k", "latent") else
                   _attention_layers(v) for k, v in cache.items()
                   if k not in ("v", "k_scale", "v_scale"))
    if isinstance(cache, (list, tuple)):
        return sum(_attention_layers(v) for v in cache)
    return 0


def _inputs(cfg, seed=0):
    """Params, a cache whose first PROMPT rows hold random keys, and the
    decode state of B live slots."""
    g = torch.Generator().manual_seed(seed)
    params = M.init_params(cfg, seed, device="cpu")
    cache = M.init_cache(cfg, B, MAX_LEN, device="cpu")
    for t in tree_leaves(cache):
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    cur = torch.randint(0, cfg.vocab_size, (B,), generator=g,
                        dtype=torch.int32)
    lengths = torch.full((B,), PROMPT, dtype=torch.int32)
    remaining = torch.tensor([K + 2, 2, K], dtype=torch.int32)
    done = torch.zeros((B,), dtype=torch.bool)
    return params, cache, cur, lengths, remaining, done


class _PlainCapture:
    """The capture backend stood in by plain closures: a capture runs the
    step's Python (its CPU operators execute), a segment's replay does
    nothing, so only the breaks' calls run on a replay."""

    def __init__(self, device):
        self._open = False
        self.pool = None

    def side(self):
        return contextlib.nullcontext()

    def begin(self):
        self._open = True

    def end(self):
        self._open = False
        return lambda: None

    def capturing(self):
        return self._open


@pytest.fixture
def plain_graphs(monkeypatch):
    """The loop takes the graphs on the CPU, with plain closures for
    segments."""
    monkeypatch.setattr(decode_graph, "_CudaCapture", _PlainCapture)
    monkeypatch.setattr(decode_graph, "decode_graph_refusal",
                        lambda t, use_kernels: None)


@pytest.fixture
def counted(monkeypatch):
    """Counting stand-ins for both decode-attention functions, which call
    the functions they replace; yields the count by name."""
    calls = {"decode_attend": 0, "mla_decode_attend": 0}
    for name in calls:
        fn = getattr(attention, name)

        def counting(*args, __fn=fn, __name=name, **kw):
            calls[__name] += 1
            return __fn(*args, **kw)

        monkeypatch.setattr(attention, name, counting)
    yield calls


# ---------------------------------------------------------------------------
REFUSALS = {
    "kernels off": (dict(kernels=False), "kernels are off"),
    "mesh": (dict(mesh=True), "a mesh is active"),
    "grad": (dict(grad=True), "grad is enabled"),
    "cost counter": (dict(counter=True), "a cost counter is active"),
    "cpu": ({}, "not a CUDA device"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusal_names_each_condition(case, monkeypatch):
    kw, reason = REFUSALS[case]
    if kw.get("mesh"):
        monkeypatch.setattr(sharding, "active_mesh", lambda: object())
    t = torch.zeros((B,), dtype=torch.int32)
    with torch.set_grad_enabled(kw.get("grad", False)), \
            (costs.counting() if kw.get("counter")
             else contextlib.nullcontext()):
        got = decode_graph.decode_graph_refusal(t, kw.get("kernels", True))
    assert got is not None and got.startswith(reason), got


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphs"])
@pytest.mark.parametrize("arch", ARCHS)
def test_break_sees_every_attention_call(arch, graphs, counted, request):
    """Every attention layer's call of every step goes through the break
    helper to the module's function: the eager loop's K steps, or a
    capture's eager step, a capture that calls nothing and K - 1 replays,
    then K replays of the captured plan."""
    if graphs:
        request.getfixturevalue("plain_graphs")
    cfg = _cfg(arch)
    params, cache, *state = _inputs(cfg)
    loop = engine.make_decode_loop(cfg, macro_steps=K)
    per_step = _attention_layers(cache)
    assert (per_step == 0) == (arch == "falcon-mamba-7b")
    with torch.no_grad():
        loop(params, cache, *state)
        assert sum(counted.values()) == per_step * K
        loop(params, cache, *state)
    name = "mla_decode_attend" if arch == "moonlight-16b-a3b" \
        else "decode_attend"
    assert counted[name] == sum(counted.values()) == per_step * 2 * K
    want = ({"decode_graph_steps": 2 * K - 1, "decode_eager_steps": 1,
             "decode_graph_captures": 1} if graphs else
            {"decode_graph_steps": 0, "decode_eager_steps": 2 * K,
             "decode_graph_captures": 0})
    assert loop.graphs.counts() == want
    if graphs:
        plan = loop.graphs._plan
        assert len(plan.breaks) == per_step
        assert len(plan.segments) == per_step + 1
        _breaks_hold_no_copy_of_the_cache(plan, cache)


def _breaks_hold_no_copy_of_the_cache(plan, cache):
    """Every tensor a break keeps views a cache leaf or is smaller than
    one layer's slice of the largest: the int8 cache's breaks keep its int8
    leaves and scales, not their f32 copies."""
    leaves = [t for t in tree_leaves(cache) if torch.is_tensor(t)]
    held = {t.untyped_storage().data_ptr() for t in leaves}
    layer = max(t[0].numel() for t in leaves)
    for b in plan.breaks:
        for a in (*b.args, *b.kw.values()):
            if torch.is_tensor(a):
                assert a.untyped_storage().data_ptr() in held \
                    or a.numel() < layer, (b.name, a.shape, a.dtype)


def test_new_cache_captures_again(plain_graphs):
    """A cache at another address, or another batch, is captured anew."""
    cfg = _cfg("llama3.2-1b")
    params, cache, *state = _inputs(cfg)
    loop = engine.make_decode_loop(cfg, macro_steps=K)
    with torch.no_grad():
        loop(params, cache, *state)
        loop(params, cache, *state)
        assert loop.graphs.captures == 1
        _, other, *state2 = _inputs(cfg, seed=1)
        loop(params, other, *state2)
        assert loop.graphs.captures == 2
    assert loop.graphs.counts()["decode_eager_steps"] == 2


def test_loop_cache_is_made_once_and_zeroed(plain_graphs):
    """``DecodeGraphs.cache`` makes the cache once for its key and hands
    the same leaves back zeroed; another key drops the graphs and makes a
    new one."""
    cfg = _cfg("llama3.2-1b")
    params, cache, *state = _inputs(cfg)
    made = []

    def make():
        made.append(M.init_cache(cfg, B, MAX_LEN, device="cpu"))
        return made[-1]

    loop = engine.make_decode_loop(cfg, macro_steps=K)
    graphs = loop.graphs
    first = graphs.cache((B, MAX_LEN), make)
    for t, src in zip(tree_leaves(first), tree_leaves(cache)):
        t.copy_(src)
    with torch.no_grad():
        loop(params, first, *state)
    again = graphs.cache((B, MAX_LEN), make)
    assert len(made) == 1 and again is first
    assert all(not t.any() for t in tree_leaves(again))
    assert graphs._plan is not None
    graphs.cache((B + 1, MAX_LEN), make)
    assert len(made) == 2 and graphs._plan is None


@pytest.mark.parametrize("arch", ["llama3.2-1b", "moonlight-16b-a3b",
                                  INT8])
def test_engines_sharing_a_loop_share_its_cache(plain_graphs, arch):
    """Two engines on one fused loop (the runtime's pair, ``share_from``)
    run in turn on the loop's one cache: the graphs are captured once, in
    the first run, and never again."""
    cfg = _cfg(arch)
    params = M.init_params(cfg, 0, device="cpu")
    first = engine.ContinuousServingEngine(
        cfg, params, slots=2, max_len=MAX_LEN, macro_steps=K, device="cpu")
    second = engine.ContinuousServingEngine(
        cfg, params, slots=2, max_len=MAX_LEN, macro_steps=K, device="cpu",
        share_from=first)
    graphs = first._fused().graphs
    assert second._fused().graphs is graphs
    caches = []
    for i, eng in enumerate((first, second, first, second)):
        _, st = eng.run(_requests(cfg))
        caches.append(graphs._cache[1])
        assert st.decode_graph_captures == (i == 0)
    assert all(c is caches[0] for c in caches)


# ---------------------------------------------------------------------------
def _launch(name, n=1):
    """``n`` calls of kernel ``name`` as ``ops`` makes them: through
    ``costs.counted``, each counted by its wrapper."""
    for _ in range(n):
        costs.counted(name, lambda: ops.count_launches({name: 1}),
                      lambda _: None)


@pytest.mark.parametrize("other_thread", [False, True],
                         ids=["alone", "prefill-thread-launching"])
def test_segment_launches_sum_to_an_eager_step(other_thread, monkeypatch):
    """Launches counted while the segments are captured are taken back, and
    each replay adds them again: K steps as graphs count what K eager steps
    count, the eager breaks counting themselves.  A thread that launches
    during the capture (the engine's shadow prefill) keeps its launches,
    counted once."""
    for fn in ops._WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(decode_graph, "_CudaCapture", _PlainCapture)

    def attend(x):
        _launch("decode_attention")
        return x + 1

    def mla_attend(x):
        _launch("mla_decode_attention", 2)
        return x * 2

    monkeypatch.setattr(attention, "decode_attend", attend)
    monkeypatch.setattr(attention, "mla_decode_attend", mla_attend)
    prefills = []

    def prefill():
        _launch("prefill_attention", 5)
        prefills.append(5)

    def step(params, cache, cur_tok, lengths, remaining, done):
        _launch("grouped_ffn", 2)
        y = attention.decode_break("decode_attend", cur_tok + params)
        _launch("ssm_scan")
        if other_thread and not prefills and \
                getattr(costs._TALLY, "counts", None) is not None:
            t = threading.Thread(target=prefill)
            t.start()
            t.join()
        y = attention.decode_break("mla_decode_attend", y)
        _launch("grouped_ffn")
        _launch("masked_compact", 3)
        cur_tok.copy_(y + cache)

    params, cache = torch.ones(()), torch.zeros(())
    vecs = [torch.zeros((B,), dtype=torch.int32) for _ in range(3)] \
        + [torch.zeros((B,), dtype=torch.bool)]
    step(params, cache, *vecs)
    one = {k: n for k, n in ops.launch_counts().items() if n}
    assert one == {"grouped_ffn": 3, "ssm_scan": 1, "masked_compact": 3,
                   "decode_attention": 1, "mla_decode_attention": 2}
    ops.reset_launch_counts()
    graphs = decode_graph.DecodeGraphs(step)
    for _ in range(2):
        graphs.run(K, params, cache, *vecs)
    assert prefills == ([5] if other_thread else [])
    assert ops.launch_counts() == {
        k: 2 * K * one.get(k, 0) + sum(prefills) * (k == "prefill_attention")
        for k in ops._WRAPPERS}
    assert graphs._plan.launches == {"grouped_ffn": 3, "ssm_scan": 1,
                                     "masked_compact": 3}
    assert graphs.counts() == {"decode_graph_steps": 2 * K - 1,
                               "decode_eager_steps": 1,
                               "decode_graph_captures": 1}


# ---------------------------------------------------------------------------
def _loop_before(cfg, eos):
    """``serving/engine.py:make_decode_loop``'s loop as it was before the
    graphs, word for word."""
    def decode_loop(params, cache, cur_tok, lengths, remaining, done):
        toks = torch.empty((K, cur_tok.shape[0]), dtype=torch.int32,
                           device=cur_tok.device)
        for i in range(K):
            out = M.forward(params, cfg,
                            {"token": cur_tok[:, None], "cache": cache,
                             "cache_index": lengths},
                            mode="decode", use_kernels=False)
            new_tok = out.logits[:, 0].argmax(dim=-1).to(torch.int32)
            active = ~done
            step = active.to(torch.int32)
            cur_tok.copy_(torch.where(active, new_tok, cur_tok))
            lengths += step
            remaining -= step
            done |= active & ((remaining <= 0) | (cur_tok == eos))
            toks[i] = cur_tok
        return toks, cache, cur_tok, lengths, remaining, done
    return decode_loop


@pytest.mark.parametrize("arch", ARCHS)
def test_eager_loop_is_bit_identical_to_before(arch):
    """The refused loop (the CPU) against the loop before the graphs, from
    equal inputs, two macro-steps, an eos that fires: tokens, state and
    every cache leaf equal bit for bit."""
    cfg = _cfg(arch)
    first = _inputs(cfg)
    with torch.no_grad():
        probe = engine.make_decode_loop(cfg, macro_steps=K)(
            first[0], *[tree_copy(x) for x in first[1:]])[0]
    eos = int(probe[1, 0])
    runs = []
    for loop in (engine.make_decode_loop(cfg, macro_steps=K, eos_id=eos),
                 _loop_before(cfg, eos)):
        params, *rest = first
        rest = [tree_copy(x) for x in rest]
        with torch.no_grad():
            toks = [loop(params, *rest)[0] for _ in range(2)]
        runs.append((toks, rest))
    (got, got_rest), (want, want_rest) = runs
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(got_rest), tree_leaves(want_rest)):
        assert torch.equal(a, b)
    assert bool(got_rest[-1][0])          # slot 0 froze on the eos


def tree_copy(x):
    if isinstance(x, dict):
        return {k: tree_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_copy(v) for v in x)
    return x.clone()


# ---------------------------------------------------------------------------
def _requests(cfg, n=5):
    rng = np.random.default_rng(3)
    return [engine.ServeRequest(uid=i, max_new=int(m), prompt=rng.integers(
        0, cfg.vocab_size, (PROMPT,)).astype(np.int32))
        for i, m in enumerate((6, 3, 9, 1, 5)[:n])]


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphs"])
def test_engine_counts_its_decode_steps(graphs, request):
    """A run's stats count each step of the fused loop once, as a graph
    step or an eager one, and the captures made in that run."""
    if graphs:
        request.getfixturevalue("plain_graphs")
    cfg = _cfg("llama3.2-1b")
    eng = engine.ContinuousServingEngine(
        cfg, M.init_params(cfg, 0, device="cpu"), slots=2, max_len=MAX_LEN,
        macro_steps=K, device="cpu")
    _, st = eng.run(_requests(cfg))
    assert st.macro_dispatches > 0
    assert st.decode_graph_steps + st.decode_eager_steps \
        == st.macro_dispatches * K
    if graphs:
        assert st.decode_graph_captures >= 1
        assert st.decode_eager_steps == st.decode_graph_captures
    else:
        assert (st.decode_graph_steps, st.decode_graph_captures) == (0, 0)
