"""The 90th percentile over every request due in the window of its first
token's landing less the time it was due; a request with no first token
when the window closes counts at the close."""
from portbench import harness

LAYER, UNIT, SOURCE = "end to end", "ms", "host_clock"


def read(run):
    p = harness.percentile(harness.ttft_s(run), 90)
    return None if p is None else 1e3 * p
