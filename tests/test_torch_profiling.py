"""``repro_torch.serving.profiling.profile_engine_programs``: the JAX
package's schema, the flops of the programs against their analytic count,
and, on (1, 2) gloo meshes, every program's collective bytes against the
collectives the sharded model issues (head-parallel, and with one kv head
Case Q: the query heads split, k and v summed, the cache sequence-sharded
with the lse merge), with none on the splice and the slot write."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_mesh_ranks as ranks  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import profiling as jprofiling  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.distributed.collectives import KINDS  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import ContinuousServingEngine  # noqa: E402
from repro_torch.serving.profiling import profile_engine_programs  # noqa: E402

ARCH, SLOTS, MAX_LEN, P = "llama3.2-1b", 2, 32, 8
F32 = 4


def _engine(K, arch=ARCH):
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    return cfg, ContinuousServingEngine(cfg, params, slots=SLOTS,
                                        max_len=MAX_LEN, macro_steps=K,
                                        device="cpu")


@pytest.fixture(scope="module")
def profiles():
    return {K: profile_engine_programs(_engine(K)[1], prompt_len=P)
            for K in (2, 4)}


def test_schema_matches_jax(profiles):
    jcfg = jreduced(jget_config(ARCH))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    jeng = jengine.ContinuousServingEngine(jcfg, jparams, slots=SLOTS,
                                           max_len=MAX_LEN, macro_steps=4)
    want = jprofiling.profile_engine_programs(jeng, prompt_len=P)
    got = profiles[4]
    assert set(got) == set(want)
    for key in ("macro_steps", "slots", "n_blocks", "prompt_len",
                "device_count"):
        assert got[key] == want[key], key
    assert set(got["programs"]) == set(want["programs"])
    for name, rec in got["programs"].items():
        assert set(rec) == set(want["programs"][name])
        assert set(want["programs"][name]["collective_bytes"]) \
            <= set(rec["collective_bytes"])
        assert set(rec["collective_bytes"]) == set(KINDS) | {"total"}


def test_off_mesh_profile_counts(profiles):
    for K, prof in profiles.items():
        for name, rec in prof["programs"].items():
            assert rec["collective_bytes"]["total"] == 0.0, name
            assert rec["bytes_accessed"] > 0.0, name
        assert prof["programs"]["splice"]["flops"] == 0.0
        assert prof["programs"]["slot_write"]["flops"] == 0.0
    # the decode dispatch is K identical steps
    two, four = profiles[2]["programs"], profiles[4]["programs"]
    assert four["decode_loop"]["flops"] == 2 * two["decode_loop"]["flops"]
    assert four["prefill"] == two["prefill"]


def test_prefill_and_decode_flops_match_analytic(profiles):
    cfg = reduced(get_config(ARCH))
    progs = profiles[4]["programs"]
    # projections, SwiGLU and the one attention chunk (P x P pairs) per
    # layer, and the last row's logits
    want_prefill = cfg.num_layers * (
        2 * P * cfg.d_model * (2 * cfg.num_heads * cfg.head_dim
                               + 2 * cfg.num_kv_heads * cfg.head_dim)
        + 2 * P * cfg.d_model * cfg.d_ff * 3
        + 2 * 2 * cfg.num_heads * cfg.head_dim * P * P) \
        + 2 * cfg.d_model * cfg.vocab_size
    assert progs["prefill"]["flops"] == want_prefill
    # a decode step: every slot's token, its attention over the whole cache
    # (the plain version scores every row and masks), all logits
    step = cfg.num_layers * (
        2 * SLOTS * cfg.d_model * (2 * cfg.num_heads * cfg.head_dim
                                   + 2 * cfg.num_kv_heads * cfg.head_dim)
        + 2 * SLOTS * cfg.d_model * cfg.d_ff * 3
        + 2 * 2 * SLOTS * cfg.num_heads * cfg.head_dim * MAX_LEN) \
        + 2 * SLOTS * cfg.d_model * cfg.vocab_size
    assert progs["decode_loop"]["flops"] == 4 * step


MESH_CASES = {"heads": {}, "seq": {"num_kv_heads": 1}}


@pytest.fixture(scope="module")
def mesh_profiles():
    return {name: run_ranks(ranks.profile_rank, 2, (1, 2), ARCH, rep, SLOTS,
                            MAX_LEN, 4, P, threads=1)
            for name, rep in MESH_CASES.items()}


def _decode_all_reduce_bytes(cfg, name, K):
    """The all_reduce bytes one rank issues in K decode steps on (1, 2):
    the vocab-parallel embedding and logits gather, and per layer the MLP's
    row-slice reduction and the output projection's, with the heads split
    (``heads``) nothing more; with one kv head (``seq``: Case Q, the query
    heads split, wk/wv on their D rows, the cache's sequence split) also
    k and v summed, the query heads gathered and the lse merge's max and
    weighted sum."""
    B, D, V, H, dh = SLOTS, cfg.d_model, cfg.vocab_size, cfg.num_heads, \
        cfg.head_dim
    per_layer = 2 * B * D * F32
    if name == "seq":
        per_layer += 2 * B * cfg.num_kv_heads * dh * F32 + B * H * dh * F32 \
            + B * H * F32 + B * H * (dh + 1) * F32
    step = B * D * F32 + cfg.num_layers * per_layer + B * V * F32
    return K * step


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_profile_collective_bytes(mesh_profiles, name):
    cfg = dataclasses.replace(reduced(get_config(ARCH)), **MESH_CASES[name])
    for prof in mesh_profiles[name]:
        assert prof["device_count"] == 2
        progs = prof["programs"]
        for prog in ("splice", "slot_write"):
            assert progs[prog]["collective_bytes"]["total"] == 0.0
        dec = progs["decode_loop"]["collective_bytes"]
        assert dec["all-reduce"] == _decode_all_reduce_bytes(cfg, name, 4)
        assert dec["total"] == dec["all-reduce"]
        pre = progs["prefill"]["collective_bytes"]
        # wo + MLP a layer, and under Case Q k and v summed
        kv = 2 * P * cfg.num_kv_heads * cfg.head_dim * F32 \
            if name == "seq" else 0
        assert pre["all-reduce"] == (
            P * cfg.d_model * F32 * (1 + 2 * cfg.num_layers)
            + cfg.num_layers * kv + cfg.vocab_size * F32)
