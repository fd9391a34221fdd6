"""HeteroEdge core on PyTorch: the paper's loop.

profiler   device/node-group capability profiles (paper §IV)
curvefit   polynomial T/E/M-vs-r fits (Eqs. 1-3)
solver     constrained split-ratio optimization (Eq. 4)
network    Shannon–Hartley link models (§V-A.2)
masking    token-level payload compression (§VI)
offload    split execution across node groups
topology   node groups + links (the 2-node pair so far)
"""
from repro_torch.core.curvefit import FittedModels, PolyFit, fit_profiles, polyfit
from repro_torch.core.masking import (CompressionReport, compress_tokens,
                                      compression_report, make_mask,
                                      norm_scores)
from repro_torch.core.network import (WIFI_2_4GHZ, WIFI_5GHZ, LinkModel,
                                      data_rate, offload_energy,
                                      offload_latency)
from repro_torch.core.offload import (GroupHealth, GroupTimeoutError,
                                      GroupUnavailableError, NodeGroup,
                                      OffloadEngine, OffloadReport,
                                      split_counts, split_sizes)
from repro_torch.core.profiler import (JETSON_NANO, JETSON_XAVIER,
                                       DeviceProfile, MeasuredProfile,
                                       paper_profiles)
from repro_torch.core.solver import (SolverConstraints, SolverResult,
                                     constraint_violations, objective,
                                     solve_split_ratio)
from repro_torch.core.topology import Topology
