"""The port's fleet host modules against the JAX package's, on the same
inputs: SplitVector and Topology.star, with_bandwidth, the battery
functions, mobility and LinkTrace, penalized / solve_joint / solve_star,
Backoff, PrefillRouter, SplitRatioController (pair and star, with and
without dead groups), TaskScheduler, TenantScheduler, kv_cache_bytes at full
width, and AdmissionController.

Tolerances: values computed in float32 on both sides from the same inputs
agree within 1e-5 relative; quantities downstream of a least-squares fit
within the fits' own 1e-3 (tests/test_torch_core.py).  ``solve_star``'s
fractions: where its 800-step descent converges the two packages agree
within 1e-4 (measured ~2e-5: XLA fuses the loop, torch runs it eagerly);
where the annealed smooth max is sharp enough that a fixed step of 0.1
overshoots the kink of max_g, the iterate ends in a limit cycle and float32
rounding picks another point of it (measured: 0.0126 apart inside a
0.0201-wide band at costs (1, 0.5)).  So the fractions are held within
1e-4 plus the width of that band, measured on the reference's last six
iterates.  The port's own band may be at most 50% wider than the
reference's, plus that tolerance: the cycle grows as the temperature
falls and is not periodic, so six iterates see another part of it on each
side (measured up to 1.21x over 40 random linear cost pairs, e.g. 0.0256
against 0.0210 at costs (35.9, 59.7)).  A port whose descent oscillates
where JAX's settles, or cycles much wider, fails.  The controllers are
compared value for value with the solve itself taken from the reference.  Integer counts are compared only where
both sides start from the same fractions."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hypothesis_compat import given, settings, strategies as st  # noqa: E402

import repro.core as JC  # noqa: E402
import repro_torch.core as C  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import list_configs as jlist_configs  # noqa: E402
from repro.core import battery as jbattery  # noqa: E402
from repro.core import mobility as jmobility  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro_torch.configs.base import get_config, list_configs  # noqa: E402
from repro_torch.core import battery, mobility, solver  # noqa: E402

RTOL = 1e-5          # float32 on both sides, same inputs
F_TOL = 1e-4         # solve_star fractions (eager torch vs XLA's fused loop)
FIT_TOL = 1e-3       # anything downstream of a least-squares fit
BAND_RTOL = 0.5      # solve_star's limit-cycle width, port against reference


def _groups(mod, dev, names=("hub", "s1", "s2")):
    return ([mod.NodeGroup(names[0], [dev], mod.JETSON_NANO)]
            + [mod.NodeGroup(n, [dev], mod.JETSON_XAVIER) for n in names[1:]])


def _star(mod, dev, names=("hub", "s1", "s2"), **kw):
    g = _groups(mod, dev, names)
    return mod.Topology.star(g[0], g[1:], mod.WIFI_5GHZ, **kw)


JDEV, TDEV = jax.devices()[0], torch.device("cpu")


# --- SplitVector -------------------------------------------------------------
SPLITS = [(2.0, 1.0, 1.0), (0.0, 0.0), (0.4, 0.3, 0.3), (1 / 3, 1 / 3, 1 / 3),
          (0.7, -0.2, 0.5), (0.0, 0.0, 1.0, 0.0), (0.05, 0.9, 0.05)]


@pytest.mark.parametrize("fr", SPLITS)
def test_split_vector_normalise_mask_counts(fr):
    j, t = JC.SplitVector(fr), C.SplitVector(fr)
    assert t.fractions == j.fractions and t.r == j.r and len(t) == len(j)
    for B in (0, 1, 2, 7, 8, 10, 33, 64):
        assert t.counts(B) == j.counts(B)
    for alive in ([True] * len(fr), [False] + [True] * (len(fr) - 1),
                  [True] + [False] * (len(fr) - 1)):
        assert t.masked(alive).fractions == j.masked(alive).fractions
    with pytest.raises(C.GroupUnavailableError):
        t.masked([False] * len(fr))
    with pytest.raises(ValueError, match="alive mask"):
        t.masked([True] * (len(fr) + 1))


@pytest.mark.parametrize("r,n", [(0.7, 2), (0.6, 4), (0.0, 3), (1.0, 3),
                                 (1.4, 2), (-0.2, 3), (0.25, 5)])
def test_split_vector_from_r(r, n):
    j, t = JC.SplitVector.from_r(r, n), C.SplitVector.from_r(r, n)
    assert t.fractions == j.fractions
    assert t.counts(16) == j.counts(16)


@settings(max_examples=40, deadline=None)
@given(B=st.integers(1, 64), a=st.floats(0.01, 1.0), b=st.floats(0.01, 1.0),
       c=st.floats(0.01, 1.0))
def test_split_vector_star_counts_equal_jax(B, a, b, c):
    assert C.SplitVector((a, b, c)).counts(B) == \
        JC.SplitVector((a, b, c)).counts(B)


@settings(max_examples=40, deadline=None)
@given(r=st.floats(0.0, 1.0), B=st.integers(1, 64))
def test_split_vector_pair_counts_equal_jax(r, B):
    assert C.SplitVector.from_r(r).counts(B) == JC.SplitVector.from_r(r).counts(B)
    assert C.SplitVector.from_r(r).counts(B) == \
        tuple(reversed(C.split_sizes(B, r)))


# --- Topology.star -----------------------------------------------------------
def test_topology_star_accessors_match():
    j, t = _star(JC, JDEV), _star(C, TDEV)
    assert (t.kind, len(t), t.prefill_spoke) == (j.kind, len(j), j.prefill_spoke)
    assert [g.name for g in t.spokes] == [g.name for g in j.spokes]
    assert t.hub.name == j.hub.name and t.prefill_group is None
    assert t.prefill_link is None and t.decode_indices() == j.decode_indices()
    assert all(link is C.WIFI_5GHZ for link in t.links[1:])
    jp = _star(JC, JDEV, ("hub", "s1", "pf"), prefill_spoke="pf")
    tp = _star(C, TDEV, ("hub", "s1", "pf"), prefill_spoke="pf")
    assert tp.prefill_spoke == jp.prefill_spoke == 2
    assert tp.prefill_group.name == "pf" and tp.prefill_link is C.WIFI_5GHZ
    assert tp.decode_indices() == jp.decode_indices() == [0, 1]
    per_edge = C.Topology.star(*_split(_groups(C, TDEV)),
                               [C.WIFI_5GHZ, C.ICI_LINK])
    assert per_edge.links == [None, C.WIFI_5GHZ, C.ICI_LINK]


def _split(groups):
    return groups[0], groups[1:]


def _errors(mod, dev):
    g = _groups(mod, dev, ("g", "g2", "g3"))
    cases = [
        lambda: mod.Topology([g[0]], [None]),
        lambda: mod.Topology([g[0], g[1]], [None]),
        lambda: mod.Topology([g[0], g[1]], [None, None]),
        lambda: mod.Topology([g[0], g[0]], [None, mod.WIFI_5GHZ]),
        lambda: mod.Topology.star(g[0], g[1:], mod.WIFI_5GHZ, prefill_spoke=0),
        lambda: mod.Topology.star(g[0], g[1:], mod.WIFI_5GHZ, prefill_spoke=3),
        lambda: mod.Topology.star(g[0], g[1:], mod.WIFI_5GHZ,
                                  prefill_spoke="nope"),
        lambda: mod.Topology.star(g[0], g[1:], mod.WIFI_5GHZ,
                                  prefill_spoke="g"),
    ]
    out = []
    for case in cases:
        with pytest.raises(ValueError) as ei:
            case()
        out.append(str(ei.value))
    return out


def test_topology_validation_errors_match():
    assert _errors(C, TDEV) == _errors(JC, JDEV)


# --- network, battery, mobility ------------------------------------------------
def test_with_bandwidth():
    for link in (C.WIFI_5GHZ, C.ICI_LINK, C.DCN_LINK):
        jl = {"WIFI": JC.WIFI_5GHZ, "ICI": JC.ICI_LINK, "DCN": JC.DCN_LINK}
        got = C.with_bandwidth(link, 3e6)
        want = JC.with_bandwidth(
            jl["WIFI" if not link.is_ici else
               ("ICI" if link.bandwidth_hz == 50e9 else "DCN")], 3e6)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.bandwidth_hz == 3e6 and link.bandwidth_hz != 3e6


BATTS = [dict(), dict(capacity_wh=0.0), dict(capacity_wh=5.0, discharge_rate=0.5),
         dict(dnn_power_w=40.0, drive_power_w=0.0)]
TIMES = [(0.0, 0.0), (60.0, 0.0), (3600.0, 1800.0), (12.5, 7.25), (1e5, 0.0)]


@pytest.mark.parametrize("bkw", BATTS)
def test_battery_functions(bkw):
    jb, tb = jbattery.BatteryState(**bkw), battery.BatteryState(**bkw)
    for td, tv in TIMES:
        for name in ("available_energy", "available_power"):
            got = getattr(battery, name)(tb, td, tv)
            want = getattr(jbattery, name)(jb, td, tv)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
        for thr in (1.0, 8.0, 1e-12):
            np.testing.assert_allclose(
                float(battery.offload_pressure(tb, td, tv, thr)),
                float(jbattery.offload_pressure(jb, td, tv, thr)), rtol=RTOL,
                atol=1e-7)


def test_mobility_model_and_should_offload():
    jc, tc = jmobility.default_latency_curve(), mobility.default_latency_curve()
    np.testing.assert_allclose(tc.coeffs.numpy(), np.asarray(jc.coeffs),
                               rtol=FIT_TOL)
    for mkw in (dict(), dict(beta=3.0), dict(v_primary=0.5, v_auxiliary=6.0)):
        jm, tm = jmobility.MobilityModel(**mkw), mobility.MobilityModel(**mkw)
        for t_s in (0.0, 0.5, 1.0, 2.5, 6.0, 20.0):
            assert float(mobility.distance(tm, t_s)) == \
                float(jmobility.distance(jm, t_s))
            np.testing.assert_allclose(
                float(mobility.latency_at(tc, tm, t_s)),
                float(jmobility.latency_at(jc, jm, t_s)), rtol=FIT_TOL,
                atol=FIT_TOL)
            assert bool(mobility.should_offload(tc, tm, t_s)) == \
                bool(jmobility.should_offload(jc, jm, t_s))


def _traces(mod, tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"distances": [4.0, 12.0, 30.0],
                                "bandwidths": [8e7, 4e7]}))
    return [mod.LinkTrace.from_spec("4,12,28,12,4"),
            mod.LinkTrace.from_spec(" 4, 30 ,", beta=20.0),
            mod.LinkTrace.from_spec(f"@{path}"),
            mod.LinkTrace(),                       # the default drift
            mod.LinkTrace(wave_dt_s=2.0, mob=mod.MobilityModel(beta=5.0))]


def test_link_trace_matches(tmp_path):
    jl = {False: JC.WIFI_5GHZ, True: JC.ICI_LINK}
    tl = {False: C.WIFI_5GHZ, True: C.ICI_LINK}
    for jt, tt in zip(_traces(JC, tmp_path), _traces(C, tmp_path)):
        assert tt.distances == jt.distances and tt.bandwidths == jt.bandwidths
        assert dataclasses.asdict(tt.mob) == dataclasses.asdict(jt.mob)
        for wave in range(8):
            assert tt.distance_at(wave) == pytest.approx(jt.distance_at(wave),
                                                         rel=RTOL)
            assert tt.latency_at(wave) == pytest.approx(jt.latency_at(wave),
                                                        rel=FIT_TOL, abs=FIT_TOL)
            assert tt.feasible(wave) == jt.feasible(wave)
            for ici in (False, True):
                got = tt.link_at(tl[ici], wave)
                want = jt.link_at(jl[ici], wave)
                assert (got is tl[ici]) == (want is jl[ici])
                assert got.bandwidth_hz == pytest.approx(want.bandwidth_hz,
                                                         rel=FIT_TOL)
    for mod in (C, JC):
        with pytest.raises(ValueError, match="empty"):
            mod.LinkTrace.from_spec(" , ")


# --- solvers ---------------------------------------------------------------------
def _paper_models():
    return JC.fit_profiles(*JC.paper_profiles()), C.fit_profiles(*C.paper_profiles())


def _table_iii(mod):
    """Table III's combined T1+T2 split by Table I's ~2.2x per-item speed
    ratio (the decomposition tests/test_solver.py uses)."""
    aux, pri, off = (mod.MeasuredProfile(n) for n in ("x", "n", "o"))
    from repro_torch.core.profiler import PAPER_TABLE_III
    for r, t3, p1, m1, t12, p2, m2 in PAPER_TABLE_III:
        w_aux, w_pri = r / 2.2, 1.0 - r
        t1 = t12 * w_aux / (w_aux + w_pri)
        aux.add(r, t1, p1, m1)
        pri.add(r, t12 - t1, p2, m2)
        off.add(r, t3, 0.0, 0.0)
    return aux, pri, off


def _star_case(case):
    """(JAX group_time_fn, port group_time_fn, n_groups) of a star case."""
    if case in ("speeds", "speeds-x60"):
        k = 60.0 if case == "speeds-x60" else 1.0
        js, ts = jnp.array([1.0, 2.0, 4.0]), torch.tensor([1.0, 2.0, 4.0])
        return (lambda f: k * f / js), (lambda f: k * f / ts), 3
    if case == "linear":
        costs = np.array([0.4, 0.15, 0.07, 0.31]) * 12
        jc = jnp.asarray(costs, jnp.float32)
        tc = torch.tensor(costs, dtype=torch.float32)
        return (lambda f: f * jc), (lambda f: f * tc), 4
    if case == "table-iii":
        jm = JC.fit_profiles(*_table_iii(JC))
        tm = C.fit_profiles(*_table_iii(C))
    else:
        jm, tm = _paper_models()
    n = 2 if case in ("table-i", "table-iii") else 3
    return (JC.group_times_from_fits(jm.T2, [(jm.T1, jm.T3)] * (n - 1)),
            C.group_times_from_fits(tm.T2, [(tm.T1, tm.T3)] * (n - 1)), n)


def _band(jfn, tfn, n, slack=F_TOL) -> float:
    """Width of the reference's last six ``solve_star`` iterates (the limit
    cycle's band; ~0 where the descent converges), after checking that the
    port's band is no wider than ``BAND_RTOL`` past it plus ``slack`` (the
    case's tolerance: ``FIT_TOL`` where both sides descend on their own
    least-squares fit)."""
    def width(solve, fn):
        fs = np.stack([np.asarray(solve(fn, n, iters=k)[0])
                       for k in range(795, 801)])
        return float((fs.max(axis=0) - fs.min(axis=0)).max())
    jband, tband = width(JC.solve_star, jfn), width(C.solve_star, tfn)
    assert tband <= jband * (1 + BAND_RTOL) + slack, (tband, jband)
    return jband


@pytest.mark.parametrize("case", ["speeds", "speeds-x60", "linear", "table-i",
                                  "table-iii", "table-i-star3"])
def test_solve_star_matches_jax(case):
    jfn, tfn, n = _star_case(case)
    jf, jt = JC.solve_star(jfn, n)
    tf, tt = C.solve_star(tfn, n)
    assert isinstance(tf, np.ndarray) and tf.dtype == np.float32
    tol = F_TOL if case in ("speeds", "speeds-x60", "linear") else FIT_TOL
    tol += _band(jfn, tfn, n, tol)
    np.testing.assert_allclose(tf, np.asarray(jf), atol=tol)
    assert tt == pytest.approx(jt, rel=tol)
    assert abs(float(tf.sum()) - 1.0) < 1e-5


@settings(max_examples=6, deadline=None)
@given(loc=st.floats(0.05, 1.0), rem=st.floats(0.05, 1.0),
       link=st.floats(0.0, 0.3), batch=st.floats(1.0, 100.0))
def test_solve_star_linear_rates_match_jax(loc, rem, link, batch):
    costs = np.array([loc, rem + link]) * batch
    jc, tc = jnp.asarray(costs, jnp.float32), torch.tensor(costs, dtype=torch.float32)
    jfn, tfn = (lambda f: f * jc), (lambda f: f * tc)
    jf, _ = JC.solve_star(jfn, 2)
    tf, _ = C.solve_star(tfn, 2)
    np.testing.assert_allclose(tf, np.asarray(jf),
                               atol=F_TOL + _band(jfn, tfn, 2))


@pytest.mark.parametrize("cons", [dict(tau=68.34), dict(tau=68.34, beta=0.9),
                                  dict(tau=68.34, m_max=(55.0, 70.0)),
                                  dict(tau=10.0)])
def test_penalized_and_solve_joint_match(cons):
    jm, tm = _paper_models()
    jc, tc = JC.SolverConstraints(**cons), C.SolverConstraints(**cons)
    for r in (0.0, 0.3, 0.7, 1.0):
        np.testing.assert_allclose(float(solver.penalized(tm, tc, r)),
                                   float(jsolver.penalized(jm, jc, r)),
                                   rtol=FIT_TOL)
    for kw in (dict(), dict(max_accuracy_loss=0.0), dict(compute_scaling=0.9)):
        jr, jk, jt = jsolver.solve_joint(jm, jc, **kw)
        tr, tk, tt = solver.solve_joint(tm, tc, **kw)
        assert tr == pytest.approx(jr, abs=2 / 256)      # one grid step
        assert tk == pytest.approx(jk, abs=1e-6)
        assert tt == pytest.approx(jt, rel=FIT_TOL)


# --- Backoff, PrefillRouter ---------------------------------------------------------
def test_backoff_schedule_matches():
    for after, maximum in ((1, 1), (2, 32), (3, 5)):
        jb, tb = JC.Backoff(after, maximum), C.Backoff(after, maximum)
        for step in range(60):
            assert tb.tick() == jb.tick()
            if step % 7 == 3:
                tb.fail(), jb.fail()
            if step % 23 == 22:
                tb.reset(), jb.reset()
            assert (tb.waves, tb.next_probe) == (jb.waves, jb.next_probe)
    for mod in (C, JC):
        with pytest.raises(ValueError):
            mod.Backoff(0)
        with pytest.raises(ValueError):
            mod.Backoff(4, 2)


def _router_script(mod, link):
    """One synthetic observation sequence through a router; returns every
    route and the router's state after each wave."""
    r = mod.PrefillRouter(link, payload_bytes=3e5, probe_every=3,
                          reprobe_after=1, reprobe_max=4)
    out = []
    waves = [dict(remote_s=0.02, n_remote=2, transfer_s=0.004, payload_bytes=6e5),
             dict(local_s=0.05, n_local=2),
             dict(remote_s=0.01, n_remote=1, transfer_s=0.001,
                  prefix_residual=0.4),
             dict(remote_s=0.02, n_remote=2, transfer_s=0.002, n_transfers=3,
                  payload_bytes=3e5),
             dict(remote_s=0.03, n_remote=3, fallbacks=1),
             dict(), dict(), dict(), dict(local_s=0.2, n_local=4),
             dict(remote_s=0.5, n_remote=1, transfer_s=0.3)]
    for i, obs in enumerate(waves):
        r.mobility_latched = i == 6
        out.append(("revive", r.maybe_revive(i >= 7)))
        d = r.route()
        out.append((d.remote, d.t_local_s, d.t_remote_s, d.reason))
        r.observe(**obs)
        out.append((r.rate_local, r.rate_remote, r.rate_transfer,
                    r.payload_bytes, r.prefix_residual, r.healthy,
                    r._down_waves, r._next_probe, r.hop_price()))
    return out


@pytest.mark.parametrize("link", ["wifi", "ici", None])
def test_prefill_router_matches(link):
    jl = {"wifi": JC.WIFI_5GHZ, "ici": JC.ICI_LINK, None: None}[link]
    tl = {"wifi": C.WIFI_5GHZ, "ici": C.ICI_LINK, None: None}[link]
    want, got = _router_script(JC, jl), _router_script(C, tl)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and not isinstance(b, bool):
                assert a == pytest.approx(b, rel=RTOL), (got, want)
            else:
                assert a == b, (g, w)


# --- SplitRatioController -------------------------------------------------------------
def _report(mod, counts, rates, links):
    names = tuple(f"g{i}" for i in range(len(counts)))
    t_group = tuple(c * r for c, r in zip(counts, rates))
    t_link = (0.0,) + tuple(c * l for c, l in zip(counts[1:], links))
    return mod.OffloadReport(
        r=1.0 - counts[0] / max(sum(counts), 1), n_local=counts[0],
        n_offloaded=sum(counts[1:]), t_local_s=t_group[0],
        t_remote_s=max(t_group[1:]), t_offload_s=max(t_link[1:]),
        payload_bytes=0.0, e_offload_j=0.0, group_names=names,
        n_group=tuple(counts), t_group_s=t_group, t_link_s=t_link)


OBS = [((4, 4, 4), (0.4, 0.1, 0.05), (0.01, 0.01)),
       ((3, 5, 4), (0.35, 0.12, 0.05), (0.02, 0.0)),
       ((2, 0, 6), (0.3, 0.1, 0.06), (0.0, 0.01)),
       ((5, 5, 2), (0.5, 0.08, 0.2), (0.01, 0.03)),
       ((4, 4, 4), (5.0, 0.01, 0.01), (0.0, 0.0)),
       ((6, 3, 3), (0.2, 0.3, 0.3), (0.0, 0.05))]


def _check_history(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.feasible == w.feasible
        assert g.r_opt == pytest.approx(w.r_opt, abs=tol)
        assert g.t_opt == pytest.approx(w.t_opt, rel=tol, abs=tol)
        assert g.t_baseline == pytest.approx(w.t_baseline, rel=RTOL, abs=0.0)
        if "fractions" in w.diagnostics:
            np.testing.assert_allclose(g.diagnostics["fractions"],
                                       w.diagnostics["fractions"], atol=tol,
                                       rtol=0.0)


def _reference_solve_star(fn, n, **kw):
    """The port controller's solve, answered by the reference: the
    controller's group_time_fn is f * costs, so f = 1 reads the costs."""
    costs = np.asarray(fn(torch.ones(n, dtype=torch.float32)))
    return JC.solve_star(lambda f: f * jnp.asarray(costs, jnp.float32), n, **kw)


@pytest.mark.parametrize("alive", [None, (True, False, True), (False, True, True)])
@pytest.mark.parametrize("update_every", [1, 2])
def test_star_controller_matches(alive, update_every, monkeypatch):
    from repro_torch.core import scheduler
    monkeypatch.setattr(scheduler, "solve_star", _reference_solve_star)
    jc = JC.SplitRatioController(JC.ControllerConfig(update_every=update_every),
                                 n_groups=3)
    tc = C.SplitRatioController(C.ControllerConfig(update_every=update_every),
                                n_groups=3)
    if alive is not None:
        jc.set_alive(alive), tc.set_alive(alive)
    assert tc.split_counts(9) == jc.split_counts(9)
    for counts, rates, links in OBS:
        r_j = jc.observe(_report(JC, counts, rates, links))
        r_t = tc.observe(_report(C, counts, rates, links))
        assert r_t == r_j
        np.testing.assert_array_equal(tc.fractions, jc.fractions)
        assert (tc.rate_local, tc._spoke_rates, tc._spoke_links) == \
            (jc.rate_local, jc._spoke_rates, jc._spoke_links)
        for n in (1, 2, 3, 9, 16):
            assert tc.split_counts(n) == jc.split_counts(n)
    _check_history(tc.history, jc.history, 0.0)
    if alive is not None:
        assert all(tc.fractions[i] == 0.0 for i, a in enumerate(alive) if not a)


def test_star_controller_own_solve_on_simplex():
    """Unstubbed, the port's own re-solve lands within the band of the
    reference's (see the module docstring) and on the simplex, floor kept."""
    jc = JC.SplitRatioController(JC.ControllerConfig(update_every=1), n_groups=3)
    tc = C.SplitRatioController(C.ControllerConfig(update_every=1), n_groups=3)
    for counts, rates, links in OBS[:3]:
        jc.observe(_report(JC, counts, rates, links))
        tc.observe(_report(C, counts, rates, links))
        f = tc.fractions
        assert abs(f.sum() - 1.0) < 1e-12 and (f >= 0.05 / 2 - 1e-12).all()
        costs = np.asarray([tc.rate_local] + [r + l for r, l in zip(
            tc._spoke_rates, tc._spoke_links)]) * tc._batch
        band = _band(lambda x: x * jnp.asarray(costs, jnp.float32),
                     lambda x: x * torch.tensor(costs, dtype=torch.float32), 3)
        np.testing.assert_allclose(f, jc.fractions, atol=F_TOL + band)


def _pair_report(mod, n_loc, n_off, t_loc, t_rem, t_off):
    return mod.OffloadReport(r=n_off / (n_loc + n_off), n_local=n_loc,
                             n_offloaded=n_off, t_local_s=t_loc,
                             t_remote_s=t_rem, t_offload_s=t_off,
                             payload_bytes=0.0, e_offload_j=0.0)


PAIR_OBS = [(4, 4, 1.2, 0.4, 0.04), (5, 3, 1.5, 0.3, 0.03),
            (2, 6, 0.5, 0.7, 0.1), (8, 0, 2.0, 0.0, 0.0),
            (3, 5, 0.6, 0.2, 0.05), (4, 4, 0.4, 1.6, 0.2)]


@pytest.mark.parametrize("alive", [None, (False, True), (True, False)])
@pytest.mark.parametrize("cfg", [dict(update_every=1), dict(update_every=2),
                                 dict(update_every=1, explore=0.0, r_max=0.8),
                                 dict(update_every=1, r_min=0.3)])
def test_pair_controller_matches(alive, cfg):
    jc = JC.SplitRatioController(JC.ControllerConfig(**cfg))
    tc = C.SplitRatioController(C.ControllerConfig(**cfg))
    if alive is not None:
        jc.set_alive(alive), tc.set_alive(alive)
    for obs in PAIR_OBS:
        r_j = jc.observe(_pair_report(JC, *obs))
        r_t = tc.observe(_pair_report(C, *obs))
        assert r_t == pytest.approx(r_j, abs=2e-3)     # Eq. 4's r* tolerance
        assert (tc.rate_local, tc.rate_remote, tc.rate_link) == \
            (jc.rate_local, jc.rate_remote, jc.rate_link)
        tc._r = jc._r                                   # counts from the same r
        for n in (1, 2, 7, 16):
            assert tc.split(n) == jc.split(n)
            assert tc.split_counts(n) == jc.split_counts(n)
        np.testing.assert_allclose(tc.fractions, jc.fractions, atol=0.0)
    _check_history(tc.history, jc.history, 2e-3)


def test_controller_errors_match():
    msgs = []
    for mod in (JC, C):
        out = []
        ctl = mod.SplitRatioController(n_groups=3)
        for bad in ([True, True], [False, False, False]):
            with pytest.raises(ValueError) as ei:
                ctl.set_alive(bad)
            out.append(str(ei.value))
        with pytest.raises(ValueError) as ei:
            ctl.observe(mod.OffloadReport(r=0.5, n_local=2, n_offloaded=2,
                                          t_local_s=0.1, t_remote_s=0.1,
                                          t_offload_s=0.0, payload_bytes=0.0,
                                          e_offload_j=0.0))
        out.append(str(ei.value))
        with pytest.raises(ValueError) as ei:
            mod.SplitRatioController(n_groups=1)
        out.append(str(ei.value))
        msgs.append(out)
    assert msgs[1] == msgs[0]


# --- TaskScheduler ------------------------------------------------------------------
def _spoke_profiles(mod, aux, off, speed):
    a2, o2 = mod.MeasuredProfile("x2"), mod.MeasuredProfile("o2")
    for s, o in zip(aux.samples, off.samples):
        a2.add(s.r, s.T / speed, s.P, s.M)
        o2.add(o.r, o.T, o.P, o.M)
    return a2, o2


def _scheduler(mod, *, star, tau=68.34, battery=None, mobility=None, **cfg):
    aux, pri, off = mod.paper_profiles()
    extra = [_spoke_profiles(mod, aux, off, 2.0)] if star else []
    return mod.TaskScheduler(
        mod.SchedulerConfig(solver_constraints=mod.SolverConstraints(tau=tau),
                            **cfg),
        aux, pri, off, battery=battery, mobility=mobility, extra_spokes=extra)


@pytest.mark.parametrize("star", [False, True], ids=["pair", "star"])
@pytest.mark.parametrize("case", ["plain", "infeasible", "battery", "mobility",
                                  "mobility-gated", "observe"])
def test_task_scheduler_decide_matches(star, case):
    kw = {}
    if case == "infeasible":
        kw["tau"] = 0.01
    decide = {}
    if case == "battery":
        kw["battery"] = "low"
        decide = dict(t_dnn_s=3000.0)
    if case in ("mobility", "mobility-gated"):
        kw["mobility"] = True
        decide = dict(elapsed_s=1.0 if case == "mobility" else 9.0)
    out = []
    for mod in (JC, C):
        kws = dict(kw)
        if kws.get("battery"):
            kws["battery"] = mod.BatteryState(capacity_wh=2.0)
        if kws.get("mobility"):
            kws["mobility"] = mod.MobilityModel()
        sched = _scheduler(mod, star=star, **kws)
        if case == "observe":
            sched.observe(0.5, 12.0, 30.0, 1.0, 5.0, 5.0, 40.0, 50.0)
            sched.observe(0.62, 14.0, 22.0, 1.1)
        out.append(sched.decide(**decide))
    want, got = out
    assert got.offload == want.offload and got.reason[:12] == want.reason[:12]
    assert got.split_ratio == pytest.approx(want.split_ratio, abs=5e-3)
    assert got.predicted_time == pytest.approx(want.predicted_time, rel=5e-3)
    if want.split is None:                   # the pair, or a mobility gate
        assert got.split is None
    else:
        np.testing.assert_allclose(got.split.fractions, want.split.fractions,
                                   atol=5e-3)


def test_task_scheduler_group_count_checked():
    aux, pri, off = C.paper_profiles()
    with pytest.raises(ValueError, match="groups"):
        C.TaskScheduler(C.SchedulerConfig(), aux, pri, off,
                        topology=_star(C, TDEV))


# --- TenantScheduler ----------------------------------------------------------------
def _tenants(mod, weights, prios):
    return {f"t{i}": mod.TenantClass(f"t{i}", priority=p, weight=w)
            for i, (w, p) in enumerate(zip(weights, prios))}


@settings(max_examples=30, deadline=None)
@given(weights=st.lists(st.integers(1, 8), min_size=2, max_size=4),
       counts=st.lists(st.integers(0, 12), min_size=2, max_size=4),
       batch=st.integers(1, 5))
def test_tenant_drr_equal_to_jax(weights, counts, batch):
    """The same arrivals drain in the same waves, item for item, with the
    same deficits and rotation after each select (so conservation, FIFO
    and urgent-first hold exactly as the reference's)."""
    k = min(len(weights), len(counts))
    prios = [i % 2 for i in range(k)]
    js = JC.TenantScheduler(_tenants(JC, [w / 2.0 for w in weights[:k]], prios))
    ts = C.TenantScheduler(_tenants(C, [w / 2.0 for w in weights[:k]], prios))
    for i in range(k):
        for j in range(counts[i]):
            assert ts.enqueue(f"t{i}", (i, j)) == js.enqueue(f"t{i}", (i, j))
    while js.backlog():
        assert ts.select(batch) == js.select(batch)
        assert ts._deficit == js._deficit and ts._rot == js._rot
        assert [ts.backlog(f"t{i}") for i in range(k)] == \
            [js.backlog(f"t{i}") for i in range(k)]
    assert ts.backlog() == 0


def test_tenant_drr_hog_equal_to_jax():
    picked = []
    for mod in (JC, C):
        sched = mod.TenantScheduler({
            "hog": mod.TenantClass("hog", priority=0, weight=7.0),
            "victim": mod.TenantClass("victim", priority=1, weight=0.25)})
        waves = []
        for r in range(24):
            for _ in range(4):
                sched.enqueue("hog", ("hog", r))
            sched.enqueue("victim", ("victim", r))
            waves.append(sched.select(2))
        picked.append(waves)
    assert picked[1] == picked[0]
    for mod in (C, JC):
        with pytest.raises(ValueError):
            mod.TenantClass("x", weight=0.0)
        with pytest.raises(ValueError):
            mod.TenantClass("x", priority=-1)
        with pytest.raises(KeyError):
            mod.TenantScheduler({"a": mod.TenantClass("a")}).enqueue("b", 1)


# --- admission ------------------------------------------------------------------------
PORT_ARCHS = [a for a in list_configs() if a in jlist_configs()]


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_kv_cache_bytes_full_width_equal(arch):
    """Every config the port has, at full width: the meta-device count
    equals JAX's eval_shape count, and nothing is allocated on either
    side."""
    for slots, max_len in ((4, 512), (1, 8192)):
        assert C.kv_cache_bytes(get_config(arch), slots, max_len) == \
            JC.kv_cache_bytes(jget_config(arch), slots, max_len)


def test_kv_cache_bytes_int8_not_ported():
    """The int8 KV cache (once not ported, hence the name) at full width:
    for every config the port has, the meta-device count of the int8 values
    and their f32 scales equals JAX's, and is below the bf16 count wherever
    the config has attention."""
    for arch in PORT_ARCHS:
        cfg = dataclasses.replace(get_config(arch), kv_quant="int8")
        jcfg = dataclasses.replace(jget_config(arch), kv_quant="int8")
        for slots, max_len in ((4, 512), (1, 8192)):
            got = C.kv_cache_bytes(cfg, slots, max_len)
            assert got == JC.kv_cache_bytes(jcfg, slots, max_len), arch
            if cfg.num_heads:
                assert got < C.kv_cache_bytes(get_config(arch), slots, max_len)


def _admission(mod, dev, budgets, busy):
    prof = dataclasses.replace(mod.JETSON_XAVIER, busy_factor=busy)
    groups = [mod.NodeGroup("pri", [dev], mod.JETSON_NANO),
              mod.NodeGroup("aux", [dev], prof),
              mod.NodeGroup("aux2", [dev, dev], mod.JETSON_XAVIER)]
    return mod.AdmissionController(groups, budgets=budgets(mod))


BUDGETS = {
    "cold": lambda m: None,
    "battery": lambda m: {"pri": m.GroupBudget(battery=m.BatteryState(capacity_wh=0.05)),
                          "aux": m.GroupBudget(battery=m.BatteryState(),
                                               power_threshold_w=2.0)},
    "drained": lambda m: {g: m.GroupBudget(battery=m.BatteryState(capacity_wh=0.0))
                          for g in ("pri", "aux", "aux2")},
    "memory": lambda m: {"aux2": m.GroupBudget(mem_lambda=1e-6)},
}


@pytest.mark.parametrize("busy", [0.0, 0.95])
@pytest.mark.parametrize("budgets", sorted(BUDGETS))
def test_admission_assess_matches(budgets, busy):
    ja = _admission(JC, JDEV, BUDGETS[budgets], busy)
    ta = _admission(C, TDEV, BUDGETS[budgets], busy)
    charges = [("pri", 0.5), ("aux", 2.0), ("aux2", 0.0), ("pri", 30.0),
               ("aux", 400.0), ("pri", 7200.0)]
    for step, (name, wall) in enumerate([(None, 0.0)] + charges):
        if name is not None:
            ja.charge(name, wall), ta.charge(name, wall)
        if step == 2:
            nbytes = JC.kv_cache_bytes(jget_config("llama3.2-1b"), 4, 512)
            ja.add_task_bytes(nbytes), ta.add_task_bytes(nbytes)
        for g, w in zip(ta.assess(), ja.assess()):
            assert (g.name, g.hot, g.reason) == (w.name, w.hot, w.reason)
            for f in ("power_headroom_w", "mem_headroom_frac", "pressure",
                      "busy_factor"):
                assert getattr(g, f) == pytest.approx(getattr(w, f), rel=RTOL,
                                                      abs=1e-6), f
        assert ta.fleet_hot() == ja.fleet_hot()
    with pytest.raises(ValueError, match="names no"):
        C.AdmissionController(ta.groups, budgets={"nope": C.GroupBudget()})
