"""The port's train step, loop, checkpoints and train launcher against the
JAX package, on ``reduced()`` float32 configs with the JAX params handed
over through numpy.

``make_train_step``: losses within 1e-4 relative at each of 3 steps
(measured under 2e-7); params after the first step within atol 1e-4
(measured up to 3.9e-5).  The first AdamW step moves an element by
``lr * g / (|g| + eps)``, which is ±lr for any |g| well above eps, so a
gradient element near zero, whose relative error is large though its
absolute error is ~1e-6 of max|g|, moves by a visible share of lr (5e-4 at
step 1): 1e-4 is a fifth of it."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.checkpoint import named_leaves  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STEP_LOSS_RTOL = 1e-4
STEP_PARAM_ATOL = 1e-4
# tests/test_training_families.py:FAMILY_REPS
FAMILY_REPS = ["qwen3-moe-235b-a22b", "falcon-mamba-7b", "zamba2-2.7b",
               "internvl2-1b", "seamless-m4t-medium"]


def _pair(arch):
    jcfg = jreduced(jget_config(arch))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                       device="cpu")
    return jcfg, jparams, cfg, params


def _np(t):
    return t.detach().numpy()


def _leaves(tree):
    """The port's leaves in JAX's order (dict keys sorted)."""
    return [t for _, t in named_leaves(tree)]


def _data(cfg, seq, batch):
    fe = bool(cfg.frontend)
    return pipeline.synthetic_lm_batches(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch,
        frontend_tokens=cfg.frontend_tokens if fe else 0,
        frontend_dim=(cfg.frontend_dim or cfg.d_model) if fe else 0))


@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "moonshot-v1-16b-a3b",
                                  "falcon-mamba-7b"])
def test_make_train_step_matches_jax(arch, microbatches):
    jcfg, jparams, cfg, params = _pair(arch)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=3)
    jstep = jax.jit(jtrain.make_train_step(
        jcfg, jopt.OptimizerConfig(**kw), remat=False, microbatches=microbatches))
    step = train.make_train_step(cfg, opt.OptimizerConfig(**kw), remat=False,
                                 microbatches=microbatches)
    jstate, state = jopt.init_opt_state(jparams), opt.init_opt_state(params)
    data = _data(cfg, 16, 8)
    for i in range(3):
        batch = next(data)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state, batch)
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=STEP_LOSS_RTOL, atol=1e-6)
        if i == 0:
            for a, b in zip(_leaves(params), jax.tree.leaves(jparams)):
                np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                           atol=STEP_PARAM_ATOL)
    assert int(state.step) == 3


@pytest.mark.parametrize("arch", FAMILY_REPS)
def test_train_loop_loss_decreases(arch):
    """tests/test_training_families.py's check on the port: 25 steps of
    batch 4 x 24 tokens, and the loss falls."""
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    seen = []
    _, state, rep = train.train_loop(
        cfg, params, _data(cfg, 24, 4),
        opt.OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=25),
        steps=25, log_every=4, callback=lambda i, m: seen.append(i))
    assert rep.final_loss < rep.first_loss, (arch, rep.losses)
    assert seen == [0, 4, 8, 12, 16, 20, 24] and len(rep.losses) == 7
    assert int(state.step) == 25 and np.isfinite(rep.losses).all()


# ---------------------------------------------------------------------------
def _zamba_pair_with_state():
    """zamba2's params and a non-trivial AdamW state in both packages."""
    jcfg, jparams, cfg, params = _pair("zamba2-2.7b")
    jstate = jopt.init_opt_state(jparams)
    g = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype), jparams)
    jparams, jstate, _ = jopt.adamw_update(jopt.OptimizerConfig(), g, jstate,
                                           jparams)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                       device="cpu")
    state = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    return jparams, jstate, params, state


def _assert_same(port_tree, jax_tree):
    mine, want = _leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(mine) == len(want)
    for a, b in zip(mine, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_checkpoint_jax_to_port_and_back(tmp_path):
    """A JAX checkpoint (f32 params and OptState) restores in the port, the
    port's in JAX, leaf for leaf equal, with the same key paths."""
    jparams, jstate, params, state = _zamba_pair_with_state()
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_checkpoint(jpath, jparams, jstate, metadata={"arch": "zamba2"})
    ckpt.save_checkpoint(ppath, params, state, metadata={"arch": "zamba2"})
    with np.load(jpath) as a, np.load(ppath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "opt/.step" in b.files and "opt/.m/embed/table" in b.files
    zeros = opt.init_opt_state(params)
    p2, s2, meta = ckpt.restore_checkpoint(jpath, params, zeros)
    assert meta == {"arch": "zamba2"}
    _assert_same(p2, jparams)
    _assert_same(s2, jstate)
    assert s2.step.dtype == torch.int32 and int(s2.step) == 1
    jp2, js2, jmeta = jckpt.restore_checkpoint(
        ppath, jparams, jopt.init_opt_state(jparams))
    assert jmeta == {"arch": "zamba2"}
    _assert_same(params, jp2)
    _assert_same(state, js2)


def test_checkpoint_reads_jax_bf16_leaves_bit_for_bit(tmp_path):
    """JAX writes a bf16 leaf as raw |V2 records (numpy has no bf16); the
    port reads it back by a bit view against a bf16 template."""
    rng = np.random.default_rng(0)
    tree = {"a": jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16),
            "b": {"c": jnp.asarray(rng.standard_normal(5), jnp.float32)}}
    path = str(tmp_path / "bf16.npz")
    jckpt.save_checkpoint(path, tree)
    with np.load(path) as z:
        assert z["params/a"].dtype == np.dtype("V2")
    like = {"a": torch.zeros((4, 6), dtype=torch.bfloat16),
            "b": {"c": torch.zeros(5)}}
    got, state, _ = ckpt.restore_checkpoint(path, like)
    assert state is None and got["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"].view(torch.int16).numpy(),
                                  np.asarray(tree["a"]).view(np.int16))
    np.testing.assert_array_equal(_np(got["b"]["c"]), np.asarray(tree["b"]["c"]))


def test_checkpoint_port_bf16_roundtrip_is_bit_exact(tmp_path):
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = M.init_params(cfg, 0, device="cpu")
    step = train.make_train_step(cfg, opt.OptimizerConfig(warmup_steps=1))
    params, state, _ = step(params, opt.init_opt_state(params),
                            next(_data(cfg, 8, 2)))
    path = str(tmp_path / "moe.npz")
    ckpt.save_checkpoint(path, params, state, metadata={"steps": 1})
    like = M.init_params(cfg, 1, device="cpu")
    p2, s2, meta = ckpt.restore_checkpoint(path, like, opt.init_opt_state(like))
    assert meta == {"steps": 1}
    for a, b in zip(_leaves((params, state)), _leaves((p2, s2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert params["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16
    assert sorted(os.listdir(tmp_path)) == ["moe.npz"]      # no temporary left


def test_tree_to_numpy_hands_trained_params_back_to_jax():
    """After a port train step, ``tree_to_numpy`` gives JAX a params tree
    whose loss under JAX's loss_fn is the port's (within 1e-4); the
    OptState keeps its type; bf16 leaves come back as float32, exactly."""
    jcfg, _, cfg, params = _pair("llama3.2-1b")
    data = _data(cfg, 16, 2)
    step = train.make_train_step(cfg, opt.OptimizerConfig(warmup_steps=1),
                                 remat=False)
    params, state, _ = step(params, opt.init_opt_state(params), next(data))
    batch = next(data)
    mine, _ = train.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    back = convert.tree_to_numpy(params)
    want, _ = jtrain.loss_fn(jax.tree.map(jnp.asarray, back), jcfg,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             remat=False)
    np.testing.assert_allclose(float(mine), float(want), rtol=1e-4)
    s = convert.tree_to_numpy(state)
    assert type(s) is opt.OptState and int(s.step) == 1
    bf = M.init_params(dataclasses.replace(cfg, dtype="bfloat16"), 0,
                       device="cpu")
    for (_, t), a in zip(named_leaves(bf), _leaves(convert.tree_to_numpy(bf))):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, t.float().numpy())


# ---------------------------------------------------------------------------
def test_train_launcher_checkpoint_restores_in_jax(tmp_path):
    """python -m repro_torch.launch.train on the CPU exits 0 and its
    checkpoint restores in JAX's restore_checkpoint."""
    path = tmp_path / "run.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "3", "--ckpt", str(path)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "device=cpu  arch=llama3.2-1b (reduced)"
    assert sum(line.startswith("step ") for line in lines) == 3
    assert lines[-2].startswith("done: 3 steps")
    jcfg = jreduced(jget_config("llama3.2-1b"))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    p, s, meta = jckpt.restore_checkpoint(str(path), jparams,
                                          jopt.init_opt_state(jparams))
    assert meta == {"arch": jcfg.name, "steps": 3}
    assert int(s.step) == 3
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(p))


def _flags(path):
    tree = ast.parse(path.read_text())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "")
            == "add_argument"}


def test_train_launcher_flags_are_jax_flags_plus_device():
    jax_flags = _flags(ROOT / "src" / "repro" / "launch" / "train.py")
    mine = _flags(ROOT / "src" / "repro_torch" / "launch" / "train.py")
    # plus the mesh flags, the serve launcher's twins (--mesh DATAxMODEL,
    # --dist-backend): JAX's launcher builds its mesh from the devices
    assert mine == jax_flags | {"--device", "--mesh", "--dist-backend"}
    assert {"--arch", "--steps", "--microbatches", "--remat", "--ckpt"} <= mine


def test_train_launcher_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only refusal")
    from repro_torch.launch import train as launcher
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--reduced", "--steps", "1"])
