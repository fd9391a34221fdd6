"""HeteroEdge core on PyTorch: the paper's loop.

profiler   device/node-group capability profiles (paper §IV)
curvefit   polynomial T/E/M-vs-r fits (Eqs. 1-3)
solver     constrained split-ratio optimization (Eq. 4) + star topology
network    Shannon–Hartley link models (§V-A.2)
battery    battery/charging constraints (Eqs. 5-6)
mobility   distance-latency model + β threshold (§V-A.5)
scheduler  online decision loop (Algorithm 1) + ingress tenant fairness
admission  power/memory/busy-factor admission boundary conditions
offload    split execution across node groups
topology   N-node topologies + the HeteroRuntime session facade (§VIII)
masking    token-level payload compression (§VI)
"""
from repro_torch.core.admission import (AdmissionController, GroupAdmission,
                                        GroupBudget, kv_cache_bytes)
from repro_torch.core.battery import (BatteryState, available_power,
                                      offload_pressure)
from repro_torch.core.curvefit import FittedModels, PolyFit, fit_profiles, polyfit
from repro_torch.core.masking import (CompressionReport, compress_tokens,
                                      compression_report, image_mask_savings,
                                      make_mask, norm_scores)
from repro_torch.core.mobility import (LinkTrace, MobilityModel,
                                       default_latency_curve)
from repro_torch.core.network import (DCN_LINK, ICI_LINK, WIFI_2_4GHZ,
                                      WIFI_5GHZ, LinkModel,
                                      data_rate, offload_energy,
                                      offload_latency, with_bandwidth)
from repro_torch.core.offload import (GroupHealth, GroupTimeoutError,
                                      GroupUnavailableError, NodeGroup,
                                      OffloadEngine, OffloadReport,
                                      mesh_axis_sizes, padded_quota_batch,
                                      split_counts, split_sizes)
from repro_torch.core.profiler import (JETSON_NANO, JETSON_XAVIER,
                                       DeviceProfile, MeasuredProfile,
                                       WorkloadCost, analytic_profile,
                                       paper_profiles)
from repro_torch.core.scheduler import (Backoff, ControllerConfig,
                                        OffloadDecision, PrefillRoute,
                                        PrefillRouter, SchedulerConfig,
                                        SplitRatioController, TaskScheduler,
                                        TenantClass, TenantScheduler)
from repro_torch.core.solver import (SolverConstraints, SolverResult,
                                     constraint_violations, objective,
                                     solve_split_ratio, solve_star)
from repro_torch.core.topology import (HeteroRuntime, ServeResult,
                                       SplitVector, TaskSpec, Topology,
                                       group_times_from_fits)
# The serving names load on first use.  Imported here eagerly, as JAX's
# package does, they break ``import repro_torch.serving.engine`` run first:
# engine imports core.offload, which runs this module, which would import
# serving.prefill, which imports engine.make_prefill_step before engine has
# defined it.  JAX's engine imports nothing of core, so it has no such cycle.
_SERVING = {
    "repro_torch.serving.frontend": (
        "FrontendError", "QueueFullError", "RequestAbortedError",
        "RequestShedError", "ServingFrontend", "TokenStream"),
    "repro_torch.serving.prefill": (
        "PrefillWorker", "PrefillWorkerError", "PrefillWorkerTimeout"),
}
_LAZY = {name: mod for mod, names in _SERVING.items() for name in names}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
