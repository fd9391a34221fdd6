"""The MoE layers' share of the device's busy time over the traced batch:
the device time of every operation launched inside the benchmark's span
around ``repro_torch.models.moe.moe_apply`` (router, dispatch, routed and
shared experts, combine; prefill and decode) over the union of the
device's busy intervals."""
from portbench import trace

LAYER, UNIT, SOURCE = "model step", "%", "device_trace"
MOVES = "tokens_per_s"
SPAN = ("repro_torch.models.moe", "moe_apply")


def read(run):
    device_s = trace.device_seconds(run.trace, SPAN[1])
    if device_s is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * device_s / run.trace.busy_s
