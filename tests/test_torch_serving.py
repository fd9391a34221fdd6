"""The port's ServingEngine against the JAX package's: the same params and
prompts give identical greedy streams and host-sync counts, at
macro_steps 0 and 8 (reduced llama3.2-1b, float32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    jcfg = jreduced(jget_config("llama3.2-1b"))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("llama3.2-1b"))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                       device="cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("macro_steps", [0, 8])
def test_generate_matches_jax(pair, macro_steps, test_seed):
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(test_seed)
    prompts = rng.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    max_new = 11                       # two fused dispatches at K=8
    want = JServingEngine(jcfg, jparams, max_len=32,
                          macro_steps=macro_steps).generate(prompts, max_new)
    eng = ServingEngine(cfg, params, max_len=32, macro_steps=macro_steps,
                        device="cpu")
    got = eng.generate(prompts, max_new)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens.shape == (3, max_new)
    assert got.host_syncs == want.host_syncs
    # every decode step the engine ran: K per dispatch, or one per token
    assert eng.decode_steps == (16 if macro_steps else max_new - 1)


def test_decode_loop_eos_freeze_matches_jax(pair, test_seed):
    """The fused loop's device-side state machine (argmax, active/lengths/
    remaining/done, eos freeze) step for step against JAX's."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(test_seed + 2)
    B, P, S, K = 3, 6, 24, 6
    prompts = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    last, pre = jax.jit(jengine.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(prompts)})
    jcache0 = jengine.seed_cache(jcfg, jM.init_cache(jcfg, B, S), pre, P)
    tok0 = np.asarray(jnp.argmax(last, -1), np.int32)
    remaining0 = np.array([5, 2, 9], np.int32)

    def port(eos):
        cache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache0), "cpu")
        state = [torch.from_numpy(a.copy()) for a in
                 (tok0, np.full(B, P, np.int32), remaining0)]
        loop = engine.make_decode_loop(cfg, macro_steps=K, eos_id=eos)
        out = loop(params, cache, *state, torch.from_numpy(remaining0 <= 0))
        return [out[0]] + list(out[2:])

    eos = int(port(None)[0][1, 0])          # slot 0 emits it at step 1
    got = port(eos)
    jloop = jax.jit(jengine.make_decode_loop(jcfg, macro_steps=K, eos_id=eos,
                                             use_pallas=False))
    want = jloop(jparams, jcache0, jnp.asarray(tok0), jnp.full((B,), P, jnp.int32),
                 jnp.asarray(remaining0), jnp.asarray(remaining0 <= 0))
    want = [want[0]] + list(want[2:])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[-1][0])                 # slot 0 froze on eos
    assert (got[0][1:, 0] == eos).all()


def test_fused_and_per_step_streams_identical(pair, test_seed):
    """Within the port, macro_steps=0 and macro_steps=K emit the same bits."""
    _, _, cfg, params = pair
    rng = np.random.default_rng(test_seed + 1)
    prompts = rng.integers(0, cfg.vocab_size, (4, 7)).astype(np.int32)
    streams = [ServingEngine(cfg, params, max_len=24, macro_steps=k,
                             device="cpu").generate(prompts, 9).tokens
               for k in (0, 3, 8)]
    for s in streams[1:]:
        np.testing.assert_array_equal(s, streams[0])


def test_launcher_static_split_on_cpu(capsys):
    """The launcher's whole static path (probe -> fit -> Eq. 4 -> payload
    compaction -> OffloadEngine) on the CPU: every request gets max_new
    tokens, the decode-step count covers every engine, no kernel launches."""
    ops.reset_launch_counts()
    s = serve.main(["--reduced", "--device", "cpu", "--requests", "5",
                    "--prompt-len", "12", "--max-new", "5", "--macro-steps", "4"])
    assert s["tokens"].shape == (5, 5)
    assert 0.0 < s["r_star"] < 1.0 and sum(s["n_group"]) == 5
    engines = 1 + sum(1 for n in s["n_group"] if n)     # the probe + groups
    assert s["decode_steps"] == engines * 4             # one dispatch of K=4
    comp = s["compression"]
    assert comp["kept_tokens_compacted"] == comp["kept_tokens"] > 0
    assert ops.launch_counts() == {"decode_attention": 0, "masked_compact": 0,
                                   "grouped_ffn": 0, "ssm_scan": 0,
                                   "ssm_scan_bwd": 0, "prefill_attention": 0,
                                   "mla_decode_attention": 0,
                                   "grouped_ffn_sorted": 0}
    assert "solver: r* =" in capsys.readouterr().out
    s8 = serve.main(["--reduced", "--device", "cpu", "--kv-int8", "--requests",
                     "5", "--prompt-len", "12", "--max-new", "5",
                     "--macro-steps", "4"])                 # the int8 cache
    assert s8["tokens"].shape == (5, 5)
    assert s8["decode_steps"] == (1 + sum(1 for n in s8["n_group"] if n)) * 4
    assert "kv=int8" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["olmo-1b", "nemotron-4-15b"])
@pytest.mark.parametrize("macro_steps", [0, 8])
def test_dense_configs_generate_matches_jax(arch, macro_steps, test_seed):
    """The main path's other dense configs: greedy streams identical to the
    JAX ServingEngine's."""
    jcfg = jreduced(jget_config(arch))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                       device="cpu")
    rng = np.random.default_rng(test_seed + 3)
    prompts = rng.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    want = JServingEngine(jcfg, jparams, max_len=32,
                          macro_steps=macro_steps).generate(prompts, 11)
    got = ServingEngine(cfg, params, max_len=32, macro_steps=macro_steps,
                        device="cpu").generate(prompts, 11)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.host_syncs == want.host_syncs
