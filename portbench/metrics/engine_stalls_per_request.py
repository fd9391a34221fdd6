"""Admission stalls (boundaries where live slots waited on a prefill that
had not been overlapped) over the requests served."""
LAYER, UNIT, SOURCE = "continuous engine", "stalls/request", "program_counter"
MOVES = "ttft_p90_ms"


def read(run):
    served = sum(w["n"] for w in run.waves)
    if not served:
        return None
    return sum(w["admission_stalls"] for w in run.waves) / served
