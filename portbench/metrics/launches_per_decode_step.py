"""Device operations a decode step: the operations launched inside the
program's ``model.decode_step`` spans over the number of those spans in
the traced batch."""
LAYER, UNIT, SOURCE = "model step", "launches/step", "device_trace"
MOVES = "tokens_per_s"


def read(run):
    p = getattr(run, "program", None)
    if p is None or not p.host_calls.get("model.decode_step") \
            or not p.device_ops.get("model.decode_step"):
        return None
    return p.device_ops["model.decode_step"] / p.host_calls["model.decode_step"]
