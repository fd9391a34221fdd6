"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, and the meta path of the kernels it counts through.

JAX's values come from ONE subprocess (``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 host devices when imported, which must not reach the
JAX tests sharing this process), within 120 s, as JSON: the shape set,
``applicable``, ``variant_config`` and ``input_specs`` (leaf shapes and
dtypes, the decode cache included) of all 10 configs at full width, and
the ``param_spec`` of every param leaf on (16, 16) and (2, 16, 16), with
and without FSDP (computed from the spec and the axis sizes; no JAX
mesh).  Held exactly:

* the shapes, ``applicable``, ``variant_config`` and ``input_specs``;
* per-rank param bytes, leaf for leaf, equal to JAX's spec, and every
  leaf on JAX's "model" dim (its fallback included) but ``moe/shared/w_*``
  (cut on the hidden width: the same bytes); the per-rank totals of all
  10 configs within 1% of JAX's;
* the train_4k records of llama3.2-1b, nemotron-4-15b, internvl2-1b and
  seamless on (16, 16) fit the card's 80 GB with the vocab-parallel loss,
  their temporaries under their bounds and their flops within 1% of the
  counts before it;
* one-rank views' collectives: a train step's calls and bytes by kind
  equal ``chip_smoke._train_collectives`` (reduced() llama, moonshot and
  falcon-mamba on (2, 2) and (2, 2, 2); llama3.2-1b and moonshot at full
  width, depth cut to 2 layers, at train_4k on (16, 16) and (2, 16, 16)),
  a decode step's all_reduces equal ``_all_reduces_per_decode_step``;
* a decode program's flops = layers x ``roofline.block_cost`` + the LM
  head's 2·B·D·V (per rank: its rows and vocab slice);
* the memory record: arguments = the rank's shards + AdamW state + inputs,
  exactly; 0 < temp < 64 x the rank's activation rows;
* each kernel entry on the meta device: the plain version's shapes and
  dtypes, exactly ``kernels/costs.py``'s numbers recorded, no plain
  version run; ``costs`` equal to the bound formulas ``chip_smoke.py``
  wrote inline before (its timing shapes);
* the loops run once for all on the meta device count what every trip
  counts (flops, bytes, kernels, peak temp), and a dense prefill counts
  on the meta device what it counts on the CPU.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, mesh_configs, reduced  # noqa: E402
from repro_torch.configs.shapes import (INPUT_SHAPES, InputShape,  # noqa: E402
                                        applicable)
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.kernels import costs, ops, ref  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_production_mesh,  # noqa: E402
                                     shard_params, train_layout)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.serving.engine import make_prefill_step  # noqa: E402
from repro_torch.serving.profiling import measure, tensor_bytes  # noqa: E402
from repro_torch.training.checkpoint import named_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ARCHS = mesh_configs()          # the JAX package's twins
META = torch.device("meta")
JAX_TIMEOUT_S = 120
TEMP_ROWS = 64          # temp < this x the rank's activation rows (below)

JAX_REF = r"""
import json, sys
import numpy as np
import jax
from repro.configs.base import get_config, list_configs, reduced
from repro.configs.shapes import INPUT_SHAPES, applicable
from repro.launch import dryrun
from repro.launch.mesh import param_spec

def names(path):
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(names(p)): [list(v.shape), str(v.dtype)] for p, v in flat}

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "reduced-2x2": {"data": 2, "model": 2}}
out = {"shapes": {n: [s.seq_len, s.global_batch, s.mode]
                  for n, s in INPUT_SHAPES.items()},
       "archs": {}, "specs": {}}
for arch in list_configs():
    cfg = get_config(arch)
    rec = {}
    for name, shape in INPUT_SHAPES.items():
        v = dryrun.variant_config(cfg, shape)
        rec[name] = {"applicable": applicable(cfg, shape),
                     "variant": {f: getattr(v, f) for f in v.__dataclass_fields__
                                 if getattr(v, f) != getattr(cfg, f)},
                     "specs": leaves(dryrun.input_specs(v, shape))}
    out["archs"][arch] = rec
    for mname, ax in MESHES.items():
        c = reduced(cfg) if mname.startswith("reduced") else cfg
        flat, _ = jax.tree_util.tree_flatten_with_path(dryrun.abstract_params(c))
        fax = tuple(a for a in ("pod", "data") if a in ax)
        fsdp_axes = (fax, int(np.prod([ax[a] for a in fax])))
        for fsdp in (True, False):
            res = {}
            for path, leaf in flat:
                n = names(path)
                stacked = "blocks" in n or "encoder" in n or "backbone" in n
                if "shared" in n and "backbone" not in n:
                    stacked = False
                spec = param_spec(path, leaf.shape, model_size=ax["model"],
                                  data_size=ax["data"], stacked=stacked,
                                  fsdp=fsdp, fsdp_axes=fsdp_axes)
                res["/".join(n)] = [list(leaf.shape), leaf.dtype.itemsize,
                                    [e if e is None or isinstance(e, str)
                                     else list(e) for e in spec]]
            out["specs"].setdefault(mname, {}).setdefault(str(fsdp), {})[arch] = res
json.dump(out, sys.stdout)
"""

MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16), "reduced-2x2": (2, 2)}


@pytest.fixture(scope="module")
def jax_ref():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_REF], env=env,
                          capture_output=True, text=True,
                          timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


def _leaves(tree):
    return {k: [list(t.shape), str(t.dtype)[6:]] for k, t in named_leaves(tree)}


def test_shapes_match_jax(jax_ref):
    assert {n: [s.seq_len, s.global_batch, s.mode]
            for n, s in INPUT_SHAPES.items()} == jax_ref["shapes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(jax_ref, arch):
    """applicable, variant_config and every input leaf's shape and dtype
    (the decode cache's too) at full width, all four shapes."""
    cfg = get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        want = jax_ref["archs"][arch][name]
        assert applicable(cfg, shape) == want["applicable"], name
        v = dryrun.variant_config(cfg, shape)
        assert {f: getattr(v, f) for f in v.__dataclass_fields__
                if getattr(v, f) != getattr(cfg, f)} == want["variant"], name
        assert _leaves(dryrun.input_specs(v, shape)) == want["specs"], name


# ---------------------------------------------------------------------------
# per-rank param bytes against JAX's param_spec
# ---------------------------------------------------------------------------
# the only leaves whose cut may differ from JAX's spec, with the same bytes:
# the MoE layer's shared experts (their hidden width, where JAX's spec,
# taking them for the hybrid's unstacked shared block, cuts their layer
# axis).  No leaf is exempt from JAX's bytes.
OWN_CUT = ("shared",)
TOTAL_RTOL = 0.01
TOTAL_ARCHS = tuple(ARCHS)


def _jax_model_dim(spec):
    return next((i for i, e in enumerate(spec) if e == "model"), None)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_vs_jax(jax_ref, arch, mesh_name, fsdp):
    mesh = _view(MESHES[mesh_name])
    sizes = dict(mesh.shape)
    cfg = get_config(arch)
    full = dryrun.abstract_params(reduced(cfg) if mesh_name.startswith(
        "reduced") else cfg)
    got = dict(named_leaves(shard_params(full, mesh, fsdp=fsdp)))
    places = _placements(full, mesh, fsdp)
    want = jax_ref["specs"][mesh_name][str(fsdp)][arch]
    assert got.keys() == want.keys()
    m = sizes["model"]
    b = _batch_size(mesh) if fsdp else 1
    differ, jax_total = {}, 0
    for k, (shape, itemsize, spec) in want.items():
        whole = math.prod(shape) * itemsize
        jax_bytes = whole
        for e in spec:
            for a in ([] if e is None else [e] if isinstance(e, str) else e):
                jax_bytes //= sizes[a]
        jax_total += jax_bytes
        pl = places[k]
        nbytes = got[k].numel() * got[k].element_size()
        # the port's own rule, every leaf
        assert nbytes == whole // (m if pl.model_dim is not None else 1) \
            // (b if pl.fsdp_dim is not None else 1), k
        names = tuple(k.split("/"))
        assert nbytes == jax_bytes, (k, nbytes, jax_bytes, spec, pl)
        if pl.model_dim != _jax_model_dim(spec):
            assert "moe" in names and any(n in names for n in OWN_CUT), \
                (k, shape, spec, pl)
            differ[k] = (pl.model_dim, _jax_model_dim(spec))
    total = sum(t.numel() * t.element_size() for t in got.values())
    print(f"param bytes {arch} {mesh_name} fsdp={fsdp}: {total} a rank, "
          f"{total / jax_total - 1:+.2%} against JAX's spec; leaves on "
          f"another model dim (port / JAX) {differ}")
    if arch in TOTAL_ARCHS and not mesh_name.startswith("reduced"):
        assert abs(total / jax_total - 1) <= TOTAL_RTOL, (total, jax_total)


def _placements(full, mesh, fsdp):
    """{key path: Placement} of every leaf (``named_leaves`` spelling)."""
    pl = train_layout(full, mesh, fsdp=fsdp).placements
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}{k}/")
        else:
            out[prefix[:-1]] = t
    walk(pl, "")
    return out


# ---------------------------------------------------------------------------
# train_4k on (16, 16) with the vocab-parallel loss
# ---------------------------------------------------------------------------
# arch: (the most GB of temporaries rank 0 may hold, the counted flops of
# its step before the loss went vocab-parallel, when its gathered logits
# held 140.1, 300.0, 152.5 and 271.8 GB of temporaries)
TRAIN_4K = {"llama3.2-1b": (20, 44_938_242_818_048),
            "nemotron-4-15b": (60, 460_867_170_729_984),
            "internvl2-1b": (65, 106_567_671_218_176),
            "seamless-m4t-medium": (25, 17_481_406_087_168)}
FLOPS_RTOL = 0.01


@pytest.mark.parametrize("arch", list(TRAIN_4K))
def test_train_4k_fits_the_card(arch):
    """rank 0 of (16, 16): its temporaries under the bound and, with its
    arguments, within the card's 80 GB; the flops those of the step that
    gathered the whole vocabulary's logits, within 1%."""
    most_gb, flops = TRAIN_4K[arch]
    res = dryrun.run_dryrun(arch, "train_4k", verbose=False)
    assert res["mesh"] == {"data": 16, "model": 16}
    temp = res["temp_size_in_bytes"]
    assert temp <= most_gb * 1e9, temp
    assert dryrun.fits(res)
    assert abs(res["flops"] / flops - 1) <= FLOPS_RTOL, (res["flops"], flops)


# ---------------------------------------------------------------------------
# collectives on one-rank views
# ---------------------------------------------------------------------------
def _view(shape):
    axes = ("pod", "data", "model")[-len(shape):]
    return Mesh(np.arange(math.prod(shape)).reshape(shape), axes, view=True)


def _batch_size(mesh):
    return mesh.axes_size(tuple(a for a in ("pod", "data") if a in mesh.shape))


def _train_case(cfg, shape, mesh_shape, remat=True):
    mesh = _view(mesh_shape)
    rec = dryrun.trace_one(cfg, shape, mesh, remat=remat)
    layout = train_layout(M.init_params(cfg, 0, device=META), mesh)
    b_loc = shape.global_batch // _batch_size(mesh)
    want = chip_smoke._train_collectives(cfg, layout, b_loc, shape.seq_len,
                                         remat=remat)
    return rec, want


def _check_collectives(rec, want):
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert rec["collective_calls"][kind] == want["calls"][kind], \
            (kind, rec["collective_calls"], want)
        assert rec["collective_bytes"][kind] == want["bytes"][kind], \
            (kind, rec["collective_bytes"], want)
    for kind in ("all-to-all", "collective-permute", "broadcast"):
        assert rec["collective_calls"][kind] == 0


REDUCED = ("llama3.2-1b", "moonshot-v1-16b-a3b", "falcon-mamba-7b")
VIEWS = [(2, 2), (2, 2, 2)]


@pytest.mark.parametrize("mesh_shape", VIEWS)
@pytest.mark.parametrize("arch", REDUCED)
def test_train_collectives_on_views(arch, mesh_shape):
    cfg = reduced(get_config(arch))
    S = 512 if cfg.family == "ssm" else 64      # two Mamba-1 chunks
    rec, want = _train_case(cfg, InputShape("t", S, 8, "train"), mesh_shape)
    _check_collectives(rec, want)


@pytest.mark.parametrize("mesh_shape", [(16, 16), (2, 16, 16)])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "moonshot-v1-16b-a3b"])
def test_full_width_train_collectives(arch, mesh_shape):
    """train_4k at full width, depth cut to 2 layers (the formula counts a
    layer's collectives; every layer issues the same)."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    rec, want = _train_case(cfg, INPUT_SHAPES["train_4k"], mesh_shape)
    _check_collectives(rec, want)
    assert rec["collective_bytes"]["all-gather"] > 0


@pytest.mark.parametrize("B", [8, 3])
@pytest.mark.parametrize("mesh_shape", VIEWS)
@pytest.mark.parametrize("arch", REDUCED)
def test_decode_all_reduces_on_views(arch, mesh_shape, B):
    """One decode step's all_reduces: B=8 splits over the batch axes, B=3
    spills onto the cache's sequence (the lse merge)."""
    cfg = reduced(get_config(arch))
    rec = dryrun.trace_one(cfg, InputShape("d", 64, B, "decode"),
                           _view(mesh_shape))
    assert rec["collective_calls"]["all-reduce"] == \
        chip_smoke._all_reduces_per_decode_step(cfg, mesh_shape, B)


# ---------------------------------------------------------------------------
# the program against its blocks; the memory record
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
def test_decode_flops_are_layers_times_block(mesh_shape):
    cfg = reduced(get_config("llama3.2-1b"))
    shape = InputShape("d", 64, 8, "decode")
    mesh = _view(mesh_shape)
    rec = dryrun.trace_one(cfg, shape, mesh)
    block = roofline.block_cost(cfg, shape, mesh)
    m = mesh.shape["model"]
    b_loc = shape.global_batch // mesh.shape["data"]
    head = 2 * b_loc * cfg.d_model * cfg.vocab_size // m
    assert rec["flops"] == cfg.num_layers * block["flops"] + head
    assert rec["kernels"]["decode_attention"]["calls"] == cfg.num_layers


def test_memory_record_train():
    """Arguments: the rank's param shards + AdamW's f32 m and v of their
    shapes + the step counter + the global batch handed in, exactly."""
    cfg = reduced(get_config("llama3.2-1b"))
    shape = InputShape("t", 64, 8, "train")
    mesh = _view((2, 2))
    rec = dryrun.trace_one(cfg, shape, mesh)
    shards = shard_params(M.init_params(cfg, 0, device=META), mesh, fsdp=True)
    p_bytes = tensor_bytes(shards)
    n_params = sum(t.numel() for _, t in named_leaves(shards))
    assert rec["argument_size_in_bytes"] == \
        p_bytes + 2 * 4 * n_params + 4 + 8 * 64 * 4
    assert sum(rec["param_bytes"].values()) == p_bytes
    # the rank's activation rows: its 4 rows x 64 tokens, every layer's
    # widest row (the vocab's logits), f32
    rows = 4 * 64 * max(cfg.d_model, cfg.d_ff, cfg.vocab_size) * 4
    assert 0 < rec["temp_size_in_bytes"] < TEMP_ROWS * rows * cfg.num_layers
    assert rec["output_size_in_bytes"] >= p_bytes
    assert rec["generated_code_size_in_bytes"] is None


def test_memory_record_decode():
    cfg = reduced(get_config("llama3.2-1b"))
    mesh = _view((2, 2))
    rec = dryrun.trace_one(cfg, InputShape("d", 64, 8, "decode"), mesh)
    shards = shard_params(M.init_params(cfg, 0, device=META), mesh)
    with sharding.activation_sharding(mesh):
        cache = M.init_cache(cfg, 8, 64, device=META)
    assert rec["argument_size_in_bytes"] == \
        tensor_bytes(shards) + tensor_bytes(cache) + 8 * 4 + 4
    assert rec["temp_size_in_bytes"] > 0


# ---------------------------------------------------------------------------
# kernels on the meta device
# ---------------------------------------------------------------------------
def _meta(*ts):
    return [t.to(META) for t in ts]


def _same_layout(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.is_meta for t in got)


def _recorded(fn):
    with costs.counting() as kc:
        out = fn()
    return out, kc.totals()


def _one_record(totals, name, cost, calls=1):
    assert totals[name] == {"calls": calls, "flops": cost["flops"],
                            "bytes": cost["bytes"]}, (totals, cost)


@pytest.mark.parametrize("variant", ["plain", "start+lse", "int-len-window"])
def test_decode_attention_on_meta(variant):
    g = torch.Generator().manual_seed(0)
    B, S, H, Hkv, dh = 3, 40, 8, 2, 16
    q = torch.randn(B, 1, H, dh, generator=g)
    k, v = torch.randn(2, B, S, Hkv, dh, generator=g)
    kw = {}
    cl = torch.tensor([40, 17, 3], dtype=torch.int32)
    if variant == "start+lse":
        kw = dict(start=torch.tensor([0, 5, 1], dtype=torch.int32), lse=True)
    if variant == "int-len-window":
        cl, kw = 30, dict(window=8)
    want = ops.decode_attention(q, k, v, cl, **kw)
    mkw = {k_: (t.to(META) if torch.is_tensor(t) else t) for k_, t in kw.items()}
    mcl = cl.to(META) if torch.is_tensor(cl) else cl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "decode_attention_ref", None)
        got, tot = _recorded(lambda: ops.decode_attention(*_meta(q, k, v), mcl,
                                                          **mkw))
    _same_layout(got, want)
    rows = B * 8 if variant == "int-len-window" else B * S  # no data: all
    _one_record(tot, "decode_attention", costs.decode_attention(
        B, H, Hkv, dh, rows, 4, start="start" in kw, lse=kw.get("lse", False)))


def test_attended_rows_read_the_lengths():
    """Off the meta device the rows come from the lengths, the window and
    the starts (what the card's launch records)."""
    cl = torch.tensor([40, 17, 3, 0])
    st = torch.tensor([0, 5, 1, 0])
    assert ops.attended_rows(cl, None, 0, 4, 32, cl.device) == 32 + 17 + 3
    assert ops.attended_rows(cl, st, 0, 4, 32, cl.device) == 32 + 12 + 2
    # a window of 8 past the cache's 32 rows holds none of them
    assert ops.attended_rows(cl, None, 8, 4, 32, cl.device) == 0 + 8 + 3
    assert ops.attended_rows(30, None, 8, 2, 32, cl.device) == 16


def test_masked_compact_on_meta():
    g = torch.Generator().manual_seed(1)
    tokens = torch.randn(3, 20, 6, generator=g)
    mask = torch.rand(3, 20, generator=g) > 0.4
    want = ops.masked_compact(tokens, mask, 12)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "masked_compact_ref", None)
        got, tot = _recorded(lambda: ops.masked_compact(*_meta(tokens, mask),
                                                        12))
    _same_layout(got, want)
    # no data on the meta device: every row that fits counts as kept
    _one_record(tot, "masked_compact", costs.masked_compact(3, 20, 6, 12, 4))


@pytest.mark.parametrize("with_counts", [False, True])
def test_grouped_ffn_on_meta(with_counts):
    g = torch.Generator().manual_seed(2)
    E, C, D, F = 3, 5, 8, 6
    buf = torch.randn(E, C, D, generator=g)
    w = [torch.randn(E, D, F, generator=g), torch.randn(E, D, F, generator=g),
         torch.randn(E, F, D, generator=g)]
    counts = torch.tensor([5, 0, 2], dtype=torch.int32) if with_counts else None
    want = ops.grouped_ffn(buf, *w, counts=counts)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "grouped_ffn_ref", None)
        got, tot = _recorded(lambda: ops.grouped_ffn(
            *_meta(buf, *w), counts=None if counts is None else counts.to(META)))
    _same_layout(got, want)
    _one_record(tot, "grouped_ffn", costs.grouped_ffn(
        E, C, D, F, 4, counts=with_counts))


def test_ssm_scan_and_backward_on_meta():
    g = torch.Generator().manual_seed(3)
    B, S, di, N = 2, 7, 3, 4
    decay = torch.rand(B, S, di, N, generator=g)
    bx = torch.randn(B, S, di, N, generator=g)
    h0 = torch.randn(B, di, N, generator=g)
    want = ops.ssm_scan(decay, bx, h0)
    calls = {"n": 0}
    real = ref.ssm_scan_ref

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "ssm_scan_ref", counting)
        mp.setattr(ref, "ssm_scan_bwd_ref", None)
        md, mb, mh = (t.to(META).requires_grad_() for t in (decay, bx, h0))
        with costs.counting() as kc:
            got = ops.ssm_scan(md, mb, mh)
            _same_layout(tuple(t.detach() for t in got), want)
            grads = torch.autograd.grad(got[0].sum(), (md, mb, mh))
    assert calls["n"] == 0
    assert [(tuple(t.shape), t.dtype) for t in grads] == \
        [((B, S, di, N), torch.float32)] * 2 + [((B, di, N), torch.float32)]
    tot = kc.totals()
    _one_record(tot, "ssm_scan", costs.ssm_scan(B, S, di, N))
    _one_record(tot, "ssm_scan_bwd", costs.ssm_scan_bwd(B, S, di, N, G=True,
                                                        g=False))


def test_meta_ssm_scan_never_runs_the_loop(monkeypatch):
    """falcon-mamba's prefill at full width and 32k tokens on the meta
    device: the recurrence is counted, its Python loop never entered."""
    monkeypatch.setattr(ref, "ssm_scan_ref", None)
    cfg = get_config("falcon-mamba-7b")
    rec = dryrun.trace_one(cfg, INPUT_SHAPES["prefill_32k"],
                           make_production_mesh(view=True))
    k = rec["kernels"]["ssm_scan"]
    assert k["calls"] == cfg.num_layers * 32768 // 256


def test_resolve_use_kernels_on_meta():
    assert ops.resolve_use_kernels("auto", META)
    assert not ops.resolve_use_kernels("auto", torch.device("cpu"))


# ---------------------------------------------------------------------------
# costs against the bound formulas chip_smoke.py wrote inline
# ---------------------------------------------------------------------------
def _inline(kind, **a):
    if kind == "decode":
        B, cl, H, Hkv, dh, es = (a[k] for k in ("B", "cl", "H", "Hkv", "dh", "es"))
        return (2 * B * cl * Hkv * dh * es + 2 * B * H * dh * es + 4 * B,
                4 * B * H * cl * dh)
    if kind == "lse":
        B, S, H, Hkv, dh, es = (a[k] for k in ("B", "S", "H", "Hkv", "dh", "es"))
        return (2 * B * H * dh * es + 2 * B * S * Hkv * dh * es + 2 * B * 4
                + B * H * 4, 4 * B * H * S * dh)
    if kind == "mc":
        B, S, D, K, kept = (a[k] for k in ("B", "S", "D", "K", "kept"))
        return B * S + kept * D * 2 + B * K * D * 2 + B * K * 4 + B * 4, 0
    if kind == "ffn_all":
        E, C, D, F = (a[k] for k in ("E", "C", "D", "F"))
        return 2 * (2 * E * C * D) + E * 3 * D * F * 2, 6 * E * C * D * F
    if kind == "ffn":
        E, C, D, F, rows, used, es = (a[k] for k in
                                      ("E", "C", "D", "F", "rows", "used", "es"))
        return (es * (rows * D + E * C * D + used * 3 * D * F) + 4 * E,
                6 * rows * D * F)
    if kind == "scan":
        B, S, C = a["B"], a["S"], a["di"] * a["N"]
        return 4 * B * C * (3 * S + 2), 2 * B * S * C
    B, S, C = a["B"], a["S"], a["di"] * a["N"]      # scan_bwd
    return 4 * B * C * (5 * S + 2), 3 * B * S * C


TIMING_SHAPES = [
    ("decode", dict(B=11, cl=145, H=32, Hkv=8, dh=64, es=2), 0.00100),
    ("lse", dict(B=3, S=256, H=16, Hkv=4, dh=64, es=2), None),
    # the kept rows and routed rows are the card's data: its bound is
    # checked there (chip_smoke's roofline phase)
    ("mc", dict(B=11, S=128, D=2048, K=128, kept=1012), None),
    ("ffn_all", dict(E=64, C=8, D=2048, F=1408), 0.332),
    ("ffn", dict(E=64, C=8, D=2048, F=1408, rows=66.0, used=38.5, es=2), None),
    ("ffn", dict(E=32, C=16, D=2048, F=1408, rows=250.5, used=31.0, es=2), None),
    ("scan", dict(B=11, S=128, di=8192, N=16), 0.665),
    ("scan", dict(B=1, S=128, di=4096, N=16), 0.0302),
    ("scan_bwd", dict(B=2, S=256, di=8192, N=16), 0.401),
    ("scan_bwd", dict(B=1, S=256, di=4096, N=16), 0.1003),
]


def _costs_of(kind, a):
    if kind == "decode":
        return costs.decode_attention(a["B"], a["H"], a["Hkv"], a["dh"],
                                      a["B"] * a["cl"], a["es"])
    if kind == "lse":
        return costs.decode_attention(a["B"], a["H"], a["Hkv"], a["dh"],
                                      a["B"] * a["S"], a["es"], start=True,
                                      lse=True)
    if kind == "mc":
        return costs.masked_compact(a["B"], a["S"], a["D"], a["K"], 2, a["kept"])
    if kind == "ffn_all":
        return costs.grouped_ffn(a["E"], a["C"], a["D"], a["F"], 2)
    if kind == "ffn":
        return costs.grouped_ffn(a["E"], a["C"], a["D"], a["F"], a["es"],
                                 routed_rows=a["rows"], experts_used=a["used"],
                                 counts=True)
    fn = costs.ssm_scan if kind == "scan" else costs.ssm_scan_bwd
    return fn(a["B"], a["S"], a["di"], a["N"])


@pytest.mark.parametrize("kind,args,bound", TIMING_SHAPES)
def test_costs_match_inline_formulas(kind, args, bound):
    c = _costs_of(kind, args)
    assert (c["bytes"], c["flops"]) == _inline(kind, **args)
    if bound is not None:      # PERF.md §6's bound column (3 figures)
        got = 1e3 * c["bytes"] / 3.35e12
        assert f"{got:.3g}" == f"{bound:.3g}", (got, bound)


# ---------------------------------------------------------------------------
# loops run once for all, and the meta device against the CPU
# ---------------------------------------------------------------------------
def _prefill_record(cfg, S, dev, use_kernels="auto"):
    p = M.init_params(cfg, 0, device=dev)
    batch = {"tokens": torch.zeros((2, S), dtype=torch.int32, device=dev)}
    if cfg.frontend:
        batch["frontend"] = torch.zeros(
            (2, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model),
            dtype=cfg.torch_dtype, device=dev)
    step = make_prefill_step(cfg, use_kernels=use_kernels)
    with torch.no_grad():
        return measure(lambda: step(p, batch), None, (p, batch))


KEYS = ("flops", "bytes_accessed", "temp_size_in_bytes", "output_size_in_bytes",
        "argument_size_in_bytes", "kernels")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "internvl2-1b"])
def test_meta_loops_once_count_every_trip(arch, monkeypatch):
    """Three query chunks x two key chunks, three scan chunks: the meta run
    with two trips standing for all against the one with every trip."""
    cfg = reduced(get_config(arch))
    S = 1536 if cfg.family in ("dense", "vlm") else 768
    once = _prefill_record(cfg, S, META)
    monkeypatch.setattr(costs, "once", lambda *t: False)
    every = _prefill_record(cfg, S, META)
    for k in KEYS:
        assert once[k] == every[k], k


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_meta_prefill_counts_what_the_cpu_counts(arch):
    """No kernel on these paths: the meta run (loops once for all) counts
    the CPU run's operators, bytes and peak temp exactly."""
    cfg = reduced(get_config(arch))
    meta = _prefill_record(cfg, 1536, META)
    cpu = _prefill_record(cfg, 1536, torch.device("cpu"), use_kernels=False)
    for k in KEYS:
        assert meta[k] == cpu[k], k


@pytest.mark.parametrize("arch,mode", [("llama3.2-1b", "train"),
                                       ("moonshot-v1-16b-a3b", "train"),
                                       ("falcon-mamba-7b", "train"),
                                       ("zamba2-2.7b", "prefill")])
def test_measure_flops_equal_flop_counter_mode(arch, mode):
    """``measure`` reads the flop registry in its one dispatch mode: the
    same total as ``torch.utils.flop_counter.FlopCounterMode`` over the
    same program (on the CPU, where every operator runs; remat on)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train import make_train_step
    cfg = reduced(get_config(arch))
    p = M.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.zeros((2, 512), dtype=torch.int32)}
    if mode == "train":
        state = init_opt_state(p)
        step = make_train_step(cfg, OptimizerConfig(), remat=True)
        fn = lambda: step(p, state, batch)  # noqa: E731
    else:
        step = make_prefill_step(cfg)
        fn = lambda: step(p, batch)  # noqa: E731
    with torch.set_grad_enabled(mode == "train"):
        got = measure(fn, None)["flops"]
        with FlopCounterMode(display=False) as fc:
            fn()
    assert got == fc.get_total_flops() > 0


# ---------------------------------------------------------------------------
# the rank view, and the launcher
# ---------------------------------------------------------------------------
def test_rank_view_counts_and_moves_nothing():
    mesh = make_production_mesh(multi_pod=True, view=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.coords == (0, 0, 0) and mesh.view
    assert mesh.group(("model",)) is coll.VIEW
    t = torch.arange(4.0)
    with coll.counting(mesh) as cc:
        out = coll.all_reduce(t.clone(), mesh, ("data",))
        coll.broadcast(t.clone(), mesh)
        g = coll.gather_sum(t, mesh, ("pod", "data"))
    assert torch.equal(out, t)
    assert g.shape == (32, 4) and torch.equal(g[0], t) and not g[1:].any()
    assert cc.calls["all-reduce"] == 2 and cc.calls["broadcast"] == 1
    assert cc.bytes["all-reduce"] == 16 + 32 * 16
    with pytest.raises(RuntimeError):
        make_production_mesh()       # no 256 ranks without the view


def test_dryrun_cli():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "long_500k"], env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "skipped" in proc.stdout and "0 failures" in proc.stdout
    res = dryrun.run_dryrun("llama3.2-1b", "decode_32k", verbose=False)
    assert res["mesh"] == {"data": 16, "model": 16} and not res["skipped"]
    assert res["rank"] == {"data": 0, "model": 0}
    assert res["kernels"]["decode_attention"]["calls"] == 16
    assert res["params"] == 1_235_746_816
    for key in ("flops", "bytes_accessed", "collective_bytes",
                "temp_size_in_bytes", "argument_size_in_bytes",
                "output_size_in_bytes", "generated_code_size_in_bytes",
                "trace_s", "param_bytes", "active_params"):
        assert key in res, key
