"""The 90th percentile over the traced batch's requests of the wait from
a request's arrival (the start of the program's ``runtime.serve`` span of
the call it came in) to the start of its first ``engine.prefill`` span,
both from the program's own records (``repro_torch.tracing``)."""
from portbench import harness, program_trace

LAYER, UNIT, SOURCE = "fleet runtime", "ms", "program_span"
MOVES = "ttft_p90_ms"


def read(run):
    p = getattr(run, "program", None)
    if p is None or p.records is None:
        return None
    q = harness.percentile(program_trace.queue_waits_s(p.records), 90)
    return None if q is None else 1e3 * q
