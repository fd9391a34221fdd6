"""Device milliseconds a prefill: the device time of the operations
launched inside the program's ``model.prefill`` spans over the number of
those spans (one a request prefilled) in the traced batch."""
from portbench import program_trace

LAYER, UNIT, SOURCE = "model step", "ms", "device_trace"
MOVES = "ttft_p90_ms"


def read(run):
    return program_trace.per_call_ms(run, "model.prefill", "model.prefill")
