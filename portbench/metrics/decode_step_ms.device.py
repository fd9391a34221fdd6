"""Device milliseconds a decode step: the device time of the operations
launched inside the program's ``model.decode_step`` spans over the
number of those spans in the traced batch."""
from portbench import program_trace

LAYER, UNIT, SOURCE = "model step", "ms", "device_trace"
MOVES = "tokens_per_s"


def read(run):
    return program_trace.per_call_ms(run, "model.decode_step",
                                     "model.decode_step")
