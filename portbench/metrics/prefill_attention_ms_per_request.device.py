"""Device milliseconds of prefill attention a prefill: the device time of
the operations launched inside the program's ``attention.full`` spans
(``chunked_attention``, every layer; in a serving cell every one runs
inside a prefill) over the ``model.prefill`` spans of the traced batch."""
from portbench import program_trace

LAYER, UNIT, SOURCE = "model step", "ms", "device_trace"
MOVES = "ttft_p90_ms"


def read(run):
    return program_trace.per_call_ms(run, "attention.full", "model.prefill")
