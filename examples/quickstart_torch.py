"""Quickstart on the PyTorch port: the HeteroEdge split-ratio optimization
in ~40 lines (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py

1. Load the paper's Table-I device profiles (Jetson Nano + Xavier).
2. Curve-fit the T/E/M-vs-r families (paper Eqs. 1-3).
3. Solve the constrained problem (Eq. 4) for the optimal split ratio.
4. Ask the online scheduler for an offload decision with mobility+battery.

Host-only: ``repro_torch.core`` on the CPU, no card needed.
"""
import repro_torch.core as C

# 1. profiles -- the paper's measurements; swap in analytic_profile(...) to
#    drive the same solver from the card's roofline terms instead.
aux_prof, pri_prof, off_prof = C.paper_profiles()

# 2. fit T1/T2/T3 (quadratic), E1/E2 (cubic), M1/M2 (quadratic)
models = C.fit_profiles(aux_prof, pri_prof, off_prof)
print(f"fit quality: T1 R²={models.T1.r2:.3f}  T2 R²={models.T2.r2:.3f}")

# 3. solve  min_r r(T1+T3) + (1-r)T2  s.t. memory/power/deadline
cons = C.SolverConstraints(tau=68.34, m_max=(55.0, 70.0), w_max=(100.0, 500.0))
res = C.solve_split_ratio(models, cons)
print(f"optimal split ratio r* = {res.r_opt:.2f} "
      f"(paper: 0.70), predicted T = {res.t_opt:.1f}s, "
      f"improvement vs local-only = {res.improvement:.0%}")

# 4. online decision with mobility + battery context
sched = C.TaskScheduler(
    C.SchedulerConfig(beta=10.0, solver_constraints=cons),
    aux_prof, pri_prof, off_prof,
    battery=C.BatteryState(), mobility=C.MobilityModel(beta=10.0))
for t in (1.0, 4.0, 8.0):
    d = sched.decide(elapsed_s=t)
    print(f"t={t:4.1f}s  offload={d.offload}  r={d.split_ratio:.2f}  "
          f"({d.reason})")
