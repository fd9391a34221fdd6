"""The port's SSM and hybrid families against the JAX package on the CPU:
the configs field for field, ``mamba1_scan`` / ``mamba2_ssd`` /
``mamba_apply`` against ``repro/models/ssm.py``, prefill and decode logits
and seeded caches of reduced falcon-mamba-7b and zamba2-2.7b, greedy
streams of ``ServingEngine``, the converter's SSM checks and the launcher
end to end.  JAX params are handed over with ``repro_torch.convert``;
inputs come from numpy at the suite seed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.serving.engine import seed_cache as jseed_cache  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.transformer import layer_slice  # noqa: E402
from repro_torch.serving.engine import ServingEngine, seed_cache  # noqa: E402

FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-2.7b"
ARCHS = [FALCON, ZAMBA]
TOL = 1e-4           # model logits (f32)
OP_TOL = 1e-5        # one op: associative against sequential order only


def _pair(arch):
    """(jax cfg, jax params, port cfg, port params) for reduced ``arch``."""
    jcfg = jreduced(jget_config(arch))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                       device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def pairs():
    return {arch: _pair(arch) for arch in ARCHS}


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _close(mine, want, tol):
    """Same tree structure (dicts and tuples), leaves within ``tol``."""
    if isinstance(want, dict):
        assert set(mine) == set(want)
        for k in want:
            _close(mine[k], want[k], tol)
    elif isinstance(want, tuple):
        assert isinstance(mine, tuple) and len(mine) == len(want)
        for m, w in zip(mine, want):
            _close(m, w, tol)
    else:
        assert tuple(mine.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(mine), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_configs_match_field_for_field(arch):
    full, jfull = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(reduced(full)) == dataclasses.asdict(jreduced(jfull))
    if arch == FALCON:
        assert full.ssm_dt_rank == 256 and reduced(full).ssm_dt_rank == 16


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's random init builds JAX's tree: same keys, shapes, dtypes
    (``D``, ``dt_bias`` and ``A_log`` in f32; the hybrid's shared block
    unstacked, with the 2-matrix gelu MLP)."""
    jcfg = jreduced(jget_config(arch))
    want = _shapes(jax.eval_shape(lambda: jM.init_params(jcfg, jax.random.PRNGKey(0))))
    got = _shapes(M.init_params(reduced(get_config(arch)), 0, device="cpu"))
    assert got == want
    pre = "blocks.backbone." if arch == ZAMBA else "blocks."
    for leaf in ("D", "dt_bias", "A_log"):
        assert got[f"{pre}mamba.{leaf}"][1] == "float32"


def _scan_inputs(rng, B, S, di, N):
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    A = -np.exp(np.log(np.tile(np.arange(1, N + 1, dtype=np.float32), (di, 1))))
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    D = rng.standard_normal(di).astype(np.float32)
    h0 = rng.standard_normal((B, di, N)).astype(np.float32)
    return u, delta, A, Bm, Cm, D, h0


def test_mamba1_scan_matches_jax(test_seed):
    """Two chunks, h0 non-zero, f32 out: within 1e-5 of JAX's associative
    scan (the port's recurrence is sequential)."""
    rng = np.random.default_rng(test_seed)
    args = _scan_inputs(rng, 2, 32, 64, 16)
    y, h = ssm.mamba1_scan(*map(_t, args), chunk=16)
    jy, jh = jssm.mamba1_scan(*map(jnp.asarray, args), chunk=16)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=OP_TOL, atol=OP_TOL)
    np.testing.assert_allclose(_np(h), np.asarray(jh), rtol=OP_TOL, atol=OP_TOL)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.mamba1_scan(*map(_t, args), chunk=12)


def test_mamba2_ssd_matches_jax(test_seed):
    rng = np.random.default_rng(test_seed)
    B, S, H, P, N = 2, 32, 4, 8, 16
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    args = (x, dt, A, Bm, Cm, D, h0)
    y, h = ssm.mamba2_ssd(*map(_t, args), chunk=16)
    jy, jh = jssm.mamba2_ssd(*map(jnp.asarray, args), chunk=16)
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=OP_TOL, atol=OP_TOL)
    np.testing.assert_allclose(_np(h), np.asarray(jh), rtol=OP_TOL, atol=OP_TOL)


@pytest.mark.parametrize("mode", ["full", "decode"])
@pytest.mark.parametrize("arch", ARCHS, ids=["mamba1", "mamba2"])
def test_mamba_apply_matches_jax(pairs, arch, mode, test_seed):
    """Output and both new states within 1e-5, from non-zero states."""
    jcfg, jparams, cfg, params = pairs[arch]
    rng = np.random.default_rng(test_seed)
    B, S = 2, 1 if mode == "decode" else 16
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    conv, hs = ssm.mamba_state_shapes(cfg, B)
    state = (rng.standard_normal(conv).astype(np.float32),
             rng.standard_normal(hs).astype(np.float32))
    jblocks = jparams["blocks"]["backbone"] if arch == ZAMBA else jparams["blocks"]
    blocks = params["blocks"]["backbone"] if arch == ZAMBA else params["blocks"]
    jp = jax.tree.map(lambda a: a[0], jblocks["mamba"])
    jy, jstate = jssm.mamba_apply(jp, jnp.asarray(x), jcfg, mode=mode,
                                  state=tuple(map(jnp.asarray, state)), scan_chunk=8)
    y, new = ssm.mamba_apply(layer_slice(blocks["mamba"], 0), _t(x), cfg, mode=mode,
                             state=tuple(map(_t, state)), scan_chunk=8)
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=OP_TOL, atol=OP_TOL)
    _close(new, tuple(jstate), OP_TOL)


def _jcache_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_forward_prefill_decode_and_seeded_cache(pairs, arch, test_seed):
    """Prefill logits, the prefill caches, the seeded decode caches and 8
    teacher-forced decode steps' logits within 1e-4 of JAX; seeding the
    port from JAX's prefill cache gives JAX's seed_cache exactly."""
    jcfg, jparams, cfg, params = pairs[arch]
    rng = np.random.default_rng(test_seed)
    B, P, steps = 2, 9, 8
    S = P + steps
    toks = rng.integers(0, cfg.vocab_size, (B, P + steps)).astype(np.int32)
    jout = jM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :P])},
                      mode="prefill")
    out = M.forward(params, cfg, {"tokens": _t(toks[:, :P])}, mode="prefill")
    np.testing.assert_allclose(_np(out.logits), np.asarray(jout.logits),
                               rtol=TOL, atol=TOL)
    _close(out.cache, _jcache_np(jout.cache), TOL)

    jcache = jseed_cache(jcfg, jM.init_cache(jcfg, B, S), jout.cache, P)
    cache = seed_cache(cfg, M.init_cache(cfg, B, S, device="cpu"), out.cache, P)
    _close(cache, _jcache_np(jcache), TOL)
    exact = seed_cache(cfg, M.init_cache(cfg, B, S, device="cpu"),
                       convert.cache_from_numpy(_jcache_np(jout.cache), "cpu"), P)
    _close(exact, _jcache_np(jcache), 0.0)

    for i in range(steps):
        tok = toks[:, P + i:P + i + 1]
        jdec = jM.forward(jparams, jcfg, {"token": jnp.asarray(tok), "cache": jcache,
                                          "cache_index": jnp.int32(P + i)},
                          mode="decode")
        jcache = jdec.cache
        dec = M.forward(params, cfg, {"token": _t(tok), "cache": cache,
                                      "cache_index": torch.tensor(P + i)},
                        mode="decode")
        assert dec.cache is cache                   # updated in place
        np.testing.assert_allclose(_np(dec.logits), np.asarray(jdec.logits),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
    _close(cache, _jcache_np(jcache), TOL)


@pytest.mark.parametrize("macro_steps", [0, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_generate_matches_jax(pairs, arch, macro_steps, test_seed):
    """Greedy streams of the port's ServingEngine equal JAX's on reduced
    falcon-mamba and zamba2 (float32), per-token and fused."""
    jcfg, jparams, cfg, params = pairs[arch]
    rng = np.random.default_rng(test_seed)
    prompts = rng.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    max_new = 11
    want = JServingEngine(jcfg, jparams, max_len=32,
                          macro_steps=macro_steps).generate(prompts, max_new)
    got = ServingEngine(cfg, params, max_len=32, macro_steps=macro_steps,
                        device="cpu").generate(prompts, max_new)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.host_syncs == want.host_syncs


def test_convert_checks_ssm_leaves(pairs):
    _, jparams, cfg, _ = pairs[FALCON]
    tree = _jcache_np(jparams)
    bad = dict(tree, blocks=dict(tree["blocks"], mamba=dict(
        tree["blocks"]["mamba"], A_log=tree["blocks"]["mamba"]["A_log"][:, :, :-1])))
    with pytest.raises(ValueError, match="A_log"):
        convert.params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="shared block"):
        convert.params_from_numpy(tree, pairs[ZAMBA][2], device="cpu")


def test_launcher_falcon_static_split_on_cpu():
    """``--arch falcon-mamba-7b --split auto`` end to end on the CPU: both
    groups are served, every request gets its tokens, and no kernel is
    launched."""
    ops.reset_launch_counts()
    s = serve.main(["--arch", FALCON, "--reduced", "--device", "cpu",
                    "--split", "auto", "--requests", "5", "--prompt-len", "12",
                    "--max-new", "5", "--macro-steps", "4"])
    assert s["tokens"].shape == (5, 5)
    assert 0 <= int(s["tokens"].min()) and int(s["tokens"].max()) < 512
    assert 0.0 < s["r_star"] < 1.0 and sum(s["n_group"]) == 5
    assert min(s["n_group"]) > 0                     # both groups served
    assert s["prefills"] == 3 and s["decode_steps"] == 3 * 4
    assert set(ops.launch_counts().values()) == {0}
