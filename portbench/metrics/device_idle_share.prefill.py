"""The traced window's share in which the device was idle and the gap is
charged to a program ``engine.prefill`` span or a span nested in it
(``program_trace.reduce``'s ``idle_under``)."""
from portbench import program_trace

LAYER, UNIT, SOURCE = "device", "%", "device_trace"
MOVES = "ttft_p90_ms"


def read(run):
    return program_trace.idle_share(run, "engine.prefill")
