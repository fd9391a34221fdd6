"""Mobility simulation on the PyTorch port (paper §VII-B Case-2 / Fig. 6;
the twin of ``examples/mobility_sim.py``).

    PYTHONPATH=src python examples/mobility_sim_torch.py

Two UGVs drive apart at (1 + 3) m/s while a stream of batches must be
processed.  Every epoch the scheduler re-profiles, re-solves, and decides:
offload at r*, shrink r, or process locally once L ≥ β.  Prints the
timeline the paper plots in Fig. 6.  Host-only: ``repro_torch.core`` on
the CPU, no card needed.
"""
import numpy as np

import repro_torch.core as C
from repro_torch.core.mobility import default_latency_curve, distance, latency_at


def main():
    mob = C.MobilityModel(v_primary=1.0, v_auxiliary=3.0, beta=10.0)
    curve = default_latency_curve()
    sched = C.TaskScheduler(
        C.SchedulerConfig(beta=mob.beta, solver_constraints=C.SolverConstraints(
            tau=68.34, m_max=(55.0, 70.0), w_max=(100.0, 500.0))),
        *C.paper_profiles(),
        battery=C.BatteryState(), mobility=mob)

    print(f"{'t(s)':>6} {'d(m)':>7} {'L(d) s':>7} {'offload':>8} "
          f"{'r':>5} {'T_pred(s)':>10}  reason")
    stopped_at = None
    for t in np.arange(0.0, 10.0, 0.5):
        d = float(distance(mob, t))
        L = float(latency_at(curve, mob, t))
        dec = sched.decide(elapsed_s=float(t), t_dnn_s=60.0,
                           t_drive_s=float(t))
        print(f"{t:6.1f} {d:7.1f} {L:7.2f} {str(dec.offload):>8} "
              f"{dec.split_ratio:5.2f} {dec.predicted_time:10.2f}  "
              f"{dec.reason[:48]}")
        if not dec.offload and stopped_at is None:
            stopped_at = d
    print(f"\noffloading stopped at d={stopped_at:.1f} m "
          f"(β={mob.beta}s; paper: latency reaches ~13.9s at 26 m)")


if __name__ == "__main__":
    main()
