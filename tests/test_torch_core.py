"""The port's paper core (curve fits, Eq. 4 solver, links, split
accounting, OffloadEngine) against the JAX package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as JC  # noqa: E402
import repro_torch.core as C  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.core.profiler import PAPER_TABLE_I as J_TABLE_I  # noqa: E402
from repro.core.profiler import PAPER_TABLE_III as J_TABLE_III  # noqa: E402
from repro.core.solver import constraint_violations as jconstraint_violations  # noqa: E402
from repro_torch.core.profiler import PAPER_TABLE_I, PAPER_TABLE_III  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def _table_iii_profiles(mod, table):
    """Aux/primary/offload profiles from Table III (r, T3, P1, M1, T1+T2, P2, M2)."""
    aux, pri, off = (mod.MeasuredProfile(n) for n in ("aux", "pri", "off"))
    for r, t3, p1, m1, t12, p2, m2 in table:
        aux.add(r, t12 * r, p1, m1)
        pri.add(r, t12 * (1 - r), p2, m2)
        off.add(r, t3, 0.0, 0.0)
    return aux, pri, off


def _fits(which):
    if which == "table-i":
        return (JC.fit_profiles(*JC.paper_profiles()),
                C.fit_profiles(*C.paper_profiles()))
    return (JC.fit_profiles(*_table_iii_profiles(JC, J_TABLE_III)),
            C.fit_profiles(*_table_iii_profiles(C, PAPER_TABLE_III)))


def test_paper_tables_copied_exactly():
    assert PAPER_TABLE_I == J_TABLE_I and PAPER_TABLE_III == J_TABLE_III


@pytest.mark.parametrize("which", ["table-i", "table-iii"])
def test_polyfit_coefficients_match(which):
    jm, tm = _fits(which)
    for name in ("T1", "T2", "T3", "E1", "E2", "M1", "M2"):
        want = np.asarray(getattr(jm, name).coeffs)
        got = getattr(tm, name).coeffs.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max())
        assert getattr(tm, name).r2 == pytest.approx(getattr(jm, name).r2, abs=1e-3)


@pytest.mark.parametrize("which,cons", [
    ("table-i", dict(tau=68.34)),
    ("table-i", dict(tau=68.34, m_max=(55.0, 70.0), w_max=(100.0, 500.0))),
    ("table-i", dict(tau=68.34, beta=0.9, deadline_slack=2.0)),
    ("table-i", dict(tau=68.34, m_max=(5.0, 5.0))),           # infeasible
    ("table-iii", dict(tau=60.0)),
], ids=["unconstrained", "mem-power", "beta", "infeasible", "table-iii"])
def test_solve_split_ratio_matches_jax(which, cons):
    jm, tm = _fits(which)
    want = JC.solve_split_ratio(jm, JC.SolverConstraints(**cons))
    got = C.solve_split_ratio(tm, C.SolverConstraints(**cons))
    assert abs(got.r_opt - want.r_opt) <= 2e-3
    assert got.feasible == want.feasible
    assert got.t_opt == pytest.approx(want.t_opt, rel=1e-3)
    assert float(C.objective(tm, 0.7)) == pytest.approx(
        float(JC.objective(jm, 0.7)), rel=1e-4)
    for r in (0.1, 0.7):
        np.testing.assert_allclose(
            C.constraint_violations(tm, C.SolverConstraints(**cons), r).numpy(),
            np.asarray(jconstraint_violations(jm, JC.SolverConstraints(**cons), r)),
            rtol=1e-3, atol=1e-3)


def test_device_profiles_match():
    """The paper testbed profiles keep the JAX numbers; only the default
    (card) constants changed from TPU v5e to H100."""
    import dataclasses
    for jp, tp in ((JC.JETSON_NANO, C.JETSON_NANO), (JC.JETSON_XAVIER, C.JETSON_XAVIER)):
        for j, t in ((jp, tp),
                     (dataclasses.replace(jp, power_budget_w=5.0, nominal_power_w=10.0,
                                          busy_factor=0.25),
                      dataclasses.replace(tp, power_budget_w=5.0, nominal_power_w=10.0,
                                          busy_factor=0.25))):
            assert t.mu_eff == j.mu_eff and t.dvfs_scale == j.dvfs_scale
            assert t.effective_flops == j.effective_flops
            assert t.exec_time(3e12, 4e9) == j.exec_time(3e12, 4e9)
            assert t.power(0.5) == j.power(0.5)
            assert t.energy(3e12, 4e9) == j.energy(3e12, 4e9)
    assert C.DeviceProfile("h100").hbm_bw == 3.35e12


def test_solver_on_exact_polynomials():
    """A test_solver.py-style hand-built model: both solvers land on the
    same r* for the same coefficients."""
    t1, t2, t3 = [2.0, 1.0, 0.0], [3.0, -8.0, 6.0], [0.5, 0.2, 0.0]
    z3, z2 = np.zeros(4, np.float32), np.zeros(3, np.float32)

    def models(mod, arr):
        P = mod.PolyFit
        return mod.FittedModels(
            T1=P(arr(t1), 1.0), T2=P(arr(t2), 1.0), T3=P(arr(t3), 1.0),
            E1=P(arr(z3), 1.0), E2=P(arr(z3), 1.0),
            M1=P(arr(z2), 1.0), M2=P(arr(z2), 1.0))

    jm = models(JC, lambda a: jnp.asarray(a, jnp.float32))
    tm = models(C, lambda a: torch.tensor(a, dtype=torch.float32))
    want = JC.solve_split_ratio(jm, JC.SolverConstraints(tau=100.0))
    got = C.solve_split_ratio(tm, C.SolverConstraints(tau=100.0))
    assert abs(got.r_opt - want.r_opt) <= 2e-3


def test_links_and_split_accounting():
    for jl, tl in ((JC.WIFI_5GHZ, C.WIFI_5GHZ), (JC.WIFI_2_4GHZ, C.WIFI_2_4GHZ),
                   (JC.LinkModel(50e9, is_ici=True, congestion=0.2),
                    C.LinkModel(50e9, is_ici=True, congestion=0.2))):
        for payload, d in ((1e3, 1.0), (3.3e6, 4.0), (7.7e7, 12.5)):
            assert C.offload_latency(tl, payload, d) == pytest.approx(
                float(JC.offload_latency(jl, payload, d)), rel=1e-6, abs=1e-6)
            assert C.offload_energy(tl, payload, d) == pytest.approx(
                float(JC.offload_energy(jl, payload, d)), rel=1e-6, abs=1e-6)
    for B in (1, 5, 16, 100):
        for r in (0.0, 0.25, 0.5, 0.66, 0.7, 1.0):
            assert C.split_sizes(B, r) == JC.split_sizes(B, r)
            assert C.split_counts((1 - r, r), B) == JC.split_counts((1 - r, r), B)
        fr = (0.2, 0.5, 0.3)
        assert C.split_counts(fr, B) == JC.split_counts(fr, B)


@pytest.fixture(scope="module")
def engines():
    jcfg = jreduced(jget_config("llama3.2-1b"))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("llama3.2-1b"))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                       device="cpu")
    return jcfg, jparams, cfg, params


def test_offload_engine_merges_like_one_group_and_jax(engines, test_seed):
    """OffloadEngine.run at r in {0, 0.7, 1}, dispatch-all-then-await
    (jit=True) and serial (jit=False), merges to the tokens of a one-group
    run, and to JAX's OffloadEngine's."""
    jcfg, jparams, cfg, params = engines
    rng = np.random.default_rng(test_seed)
    prompts = rng.integers(0, cfg.vocab_size, (5, 6)).astype(np.int32)
    cpu = torch.device("cpu")

    def task(b):
        return ServingEngine(cfg, params, max_len=16, device="cpu").generate(
            np.asarray(b["tokens"]), max_new=4).tokens

    def jtask(b):
        return JServingEngine(jcfg, jparams, max_len=16).generate(
            np.asarray(b["tokens"]), max_new=4).tokens

    whole = task({"tokens": prompts})
    dev = jax.devices()[0]
    jeng = JC.OffloadEngine(jtask, JC.NodeGroup("primary", [dev], JC.JETSON_NANO),
                            JC.NodeGroup("auxiliary", [dev], JC.JETSON_XAVIER),
                            JC.WIFI_5GHZ, payload_bytes_per_item=1e4, jit=False)
    jrep = jeng.run({"tokens": prompts}, 0.7)
    np.testing.assert_array_equal(whole, np.asarray(jrep.outputs))
    for jit in (True, False):
        eng = C.OffloadEngine(task, C.NodeGroup("primary", [cpu], C.JETSON_NANO),
                              C.NodeGroup("auxiliary", [cpu], C.JETSON_XAVIER),
                              C.WIFI_5GHZ, payload_bytes_per_item=1e4, jit=jit)
        for r in (0.0, 0.7, 1.0):
            rep = eng.run({"tokens": prompts}, r)
            np.testing.assert_array_equal(rep.outputs, whole)
            assert rep.n_group == JC.split_counts((1 - r, r), 5)
            if r == 0.7:
                assert rep.n_offloaded == jrep.n_offloaded
                assert rep.t_offload_s == pytest.approx(jrep.t_offload_s, rel=1e-6)
                assert rep.payload_bytes == jrep.payload_bytes


def test_offload_engine_group_faults():
    """A dead group fails fast at dispatch; a wedged one surfaces as a
    timeout (or refuses at once with no timeout configured)."""
    cpu = torch.device("cpu")
    pri = C.NodeGroup("primary", [cpu], C.JETSON_NANO)
    aux = C.NodeGroup("auxiliary", [cpu], C.JETSON_XAVIER)
    eng = C.OffloadEngine(lambda b: b["x"] * 2, pri, aux, C.WIFI_5GHZ,
                          payload_bytes_per_item=1.0, group_timeout_s=0.05)
    batch = {"x": torch.arange(4)}
    assert torch.equal(eng.run(batch, 0.5).outputs, torch.arange(4) * 2)
    aux.kill()
    with pytest.raises(C.GroupUnavailableError, match="auxiliary"):
        eng.run(batch, 0.5)
    aux.restore()
    aux.health.wedge()
    with pytest.raises(C.GroupTimeoutError):
        eng.run(batch, 0.5)
    aux.restore()
    aux.health.wedge()
    eng.group_timeout_s = None
    with pytest.raises(C.GroupUnavailableError, match="wedged"):
        eng.run(batch, 0.5)
    aux.restore()
    aux.inject_fault("dispatch", after=1)          # fires on the 2nd dispatch
    eng.run(batch, 0.5)
    with pytest.raises(C.GroupUnavailableError, match="died on dispatch #2"):
        eng.run(batch, 0.5)
    assert not aux.alive
    aux.restore()
    aux.inject_fault("await", timeout=True)
    with pytest.raises(C.GroupTimeoutError, match="timed out on await"):
        eng.run(batch, 0.5)
