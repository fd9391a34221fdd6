"""The time per output token's 90th percentile, read as a per-layer
metric: over every request with two or more tokens landed in the window,
(its last landing - its first) / (its tokens - 1).  Tokens land eight at
a time, once a fused macro-step, so the number follows the host-paced
decode step, whose wall swings with the host's speed; in a traced run it
also carries the profiler's cost in the traced batch."""
from portbench import harness

LAYER, UNIT, SOURCE = "continuous engine", "ms", "host_clock"
MOVES = "tokens_per_s"


def read(run):
    p = harness.percentile(harness.tpot_s(run), 90)
    return None if p is None else 1e3 * p
