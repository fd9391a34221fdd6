"""The port's training path against the JAX package, on ``reduced()``
float32 configs with the JAX params handed over through numpy: the
synthetic corpus, ``cross_entropy``, ``forward(mode="train")``, the
``loss_fn`` gradients leaf by leaf (with and without remat), ``lr_at`` and
``adamw_update``.

Tolerances: logits, aux and losses within 1e-4 (measured under 2e-6);
gradients within 1e-4 of each leaf's max|g| (measured under 5e-6: the same
f32 math summed in another order); the optimizer within 1e-6."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train  # noqa: E402
from repro_torch.training.checkpoint import named_leaves  # noqa: E402

ARCHS = ["llama3.2-1b", "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b",
         "falcon-mamba-7b", "zamba2-2.7b", "internvl2-1b",
         "seamless-m4t-medium"]
TOL = 1e-4
GRAD_TOL = 1e-4      # of each leaf's max|g|
OPT_TOL = 1e-6


def data_config(cfg, seq, batch, seed=0):
    fe = bool(cfg.frontend)
    return dict(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch,
                seed=seed, frontend_tokens=cfg.frontend_tokens if fe else 0,
                frontend_dim=(cfg.frontend_dim or cfg.d_model) if fe else 0)


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(jax cfg, jax params, port cfg, port params, numpy batch)."""
    jcfg = jreduced(jget_config(arch))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                       device="cpu")
    batch = next(pipeline.synthetic_lm_batches(
        pipeline.DataConfig(**data_config(cfg, 16, 2))))
    return jcfg, jparams, cfg, params, batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _leaves(tree):
    """The port's leaves in JAX's order (dict keys sorted)."""
    return [t for _, t in named_leaves(tree)]


def _leaves_close(got, want, tol):
    got, want = _leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(_np(g) - w).max() <= tol * scale, \
            (np.abs(_np(g) - w).max(), scale)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-1b"])
def test_synthetic_lm_batches_match_jax(arch):
    """The first three batches equal JAX's, the vlm's with its frontend."""
    cfg = reduced(get_config(arch))
    kw = data_config(cfg, 12, 3, seed=5)
    mine = pipeline.synthetic_lm_batches(pipeline.DataConfig(**kw))
    want = jpipeline.synthetic_lm_batches(jpipeline.DataConfig(**kw))
    for _ in range(3):
        a, b = next(mine), next(want)
        assert sorted(a) == sorted(b) == (["frontend", "tokens"] if cfg.frontend
                                          else ["tokens"])
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked, test_seed):
    rng = np.random.default_rng(test_seed)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (np.arange(7) >= 2) if masked else None
    mine = M.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    want = jM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(mine), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    """Logits over every position, the aux loss and the loss mask (the
    vlm's prologue rows carry none); no caches."""
    jcfg, jparams, cfg, params, batch = pair(arch)
    out = M.forward(params, cfg, _t(batch), mode="train")
    want = jM.forward(jparams, jcfg, _j(batch), mode="train")
    assert out.cache is None
    assert tuple(out.logits.shape) == want.logits.shape
    np.testing.assert_allclose(_np(out.logits), np.asarray(want.logits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(out.aux_loss), float(want.aux_loss),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(_np(out.loss_mask), np.asarray(want.loss_mask))
    if cfg.family == "vlm":
        assert not out.loss_mask[:cfg.frontend_tokens].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_grads_match_jax(arch):
    """Loss, CE, aux and every leaf's gradient against jax.value_and_grad of
    JAX's loss_fn; remat=True gives the port's remat=False gradients (the
    recomputed forward is the same arithmetic: within 1e-6 of max|g|)."""
    jcfg, jparams, cfg, params, batch = pair(arch)
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: jtrain.loss_fn(p, jcfg, _j(batch), remat=False),
        has_aux=True)(jparams)
    loss, parts, grads = train.value_and_grad(params, cfg, _t(batch), remat=False)
    np.testing.assert_allclose(float(loss), float(jl), rtol=TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=TOL, atol=TOL)
    _leaves_close(grads, jg, GRAD_TOL)
    loss_r, _, grads_r = train.value_and_grad(params, cfg, _t(batch), remat=True)
    assert float(loss_r) == float(loss)
    _leaves_close(grads_r, jax.tree.map(_np, grads), 1e-6)


def test_train_forward_writes_no_param_in_place():
    """Train mode writes nothing in place: every param's version counter
    stands after a forward and a backward (hybrid: SSM states, shared
    block)."""
    _, _, cfg, params, batch = pair("zamba2-2.7b")
    leaves = _leaves(params)
    before = [t._version for t in leaves]
    train.value_and_grad(params, cfg, _t(batch))
    assert [t._version for t in leaves] == before


# ---------------------------------------------------------------------------
OPT_CFG = dict(lr=1e-3, warmup_steps=10, total_steps=50)


@pytest.mark.parametrize("step", [0, 1, 10, 11, 30, 50])
def test_lr_at_matches_jax(step):
    mine = opt.lr_at(opt.OptimizerConfig(**OPT_CFG), step)
    want = jopt.lr_at(jopt.OptimizerConfig(**OPT_CFG), step)
    assert mine.dtype == torch.float32
    np.testing.assert_allclose(float(mine), float(want), rtol=OPT_TOL, atol=0)


def _opt_tree(rng):
    """Matrices, an L-stacked norm scale [L,d] (decays: ndim 2 counts the
    stacked axis) and a final norm [d] (does not)."""
    return {"blocks": {"ln1": {"scale": 1 + 0.1 * rng.standard_normal((3, 8))},
                       "w": rng.standard_normal((3, 8, 5))},
            "final_norm": {"scale": 1 + 0.1 * rng.standard_normal(8)},
            "lm_head": {"table": rng.standard_normal((11, 8))}}


def test_adamw_update_matches_jax(test_seed):
    """Two updates from the same gradients (clipped: global norm > 1):
    params, m, v, grad_norm and lr within 1e-6."""
    rng = np.random.default_rng(test_seed)
    p0 = jax.tree.map(lambda a: a.astype(np.float32), _opt_tree(rng))
    gs = [jax.tree.map(lambda a: (a * 0.7).astype(np.float32), _opt_tree(rng))
          for _ in range(2)]
    ocfg = dict(OPT_CFG, warmup_steps=1)
    params = convert.tree_from_numpy(p0, "cpu")
    state = opt.init_opt_state(params)
    jp, js = jax.tree.map(jnp.asarray, p0), jopt.init_opt_state(p0)
    for g in gs:
        params, state, stats = opt.adamw_update(
            opt.OptimizerConfig(**ocfg), convert.tree_from_numpy(g, "cpu"),
            state, params)
        jp, js, jstats = jopt.adamw_update(jopt.OptimizerConfig(**ocfg),
                                           jax.tree.map(jnp.asarray, g), js, jp)
        assert float(jstats["grad_norm"]) > 1.0          # the clip is active
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                       rtol=OPT_TOL)
        assert int(state.step) == int(js.step)
        for mine, want in ((params, jp), (state.m, js.m), (state.v, js.v)):
            for a, b in zip(_leaves(mine), jax.tree.leaves(want)):
                np.testing.assert_allclose(_np(a), np.asarray(b),
                                           rtol=OPT_TOL, atol=OPT_TOL)


def test_adamw_decay_rule_counts_the_stacked_axis(test_seed):
    """With zero gradients only weight decay moves a param: the stacked
    [L,d] norm scale shrinks by lr * wd * p, the [d] final norm stays."""
    p0 = jax.tree.map(lambda a: a.astype(np.float32),
                      _opt_tree(np.random.default_rng(test_seed)))
    params = convert.tree_from_numpy(p0, "cpu")
    zeros = jax.tree.map(np.zeros_like, p0)
    ocfg = opt.OptimizerConfig(**dict(OPT_CFG, warmup_steps=0))
    opt.adamw_update(ocfg, convert.tree_from_numpy(zeros, "cpu"),
                     opt.init_opt_state(params), params)
    lr = float(opt.lr_at(ocfg, 1))
    np.testing.assert_array_equal(_np(params["final_norm"]["scale"]),
                                  p0["final_norm"]["scale"])
    for got, want in ((params["blocks"]["ln1"]["scale"], p0["blocks"]["ln1"]["scale"]),
                      (params["lm_head"]["table"], p0["lm_head"]["table"])):
        np.testing.assert_allclose(_np(got), want * (1 - lr * ocfg.weight_decay),
                                   rtol=1e-6)
