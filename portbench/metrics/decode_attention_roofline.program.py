"""``decode_attention_roofline``'s formula (the least time of the K and V
rows each generated token of the traced batch needs, every layer, by the
frozen ``yardstick.decode_attention_cost``) over the device time of the
operations launched inside the program's own ``kernels.decode_attention``
spans."""
from portbench import yardstick

LAYER, UNIT, SOURCE = "kernels", "%", "device_trace"
MOVES = "tokens_per_s"


def read(run):
    p = getattr(run, "program", None)
    device_s = None if p is None else p.device_s.get(
        "kernels.decode_attention")
    if not device_s:
        return None
    c = run.sizes
    esize = 2 if c.dtype == "bfloat16" else 4
    least = 0.0
    for r in run.requests.values():
        if r.tokens is None or r.batch not in run.traced_batches:
            continue
        for j in range(1, r.max_new):       # token j attends P + j rows
            cost = yardstick.decode_attention_cost(
                1, c.num_heads, c.num_kv_heads, c.head_dim,
                r.prompt_len + j, esize)
            least += c.num_layers * yardstick.roofline_seconds(
                cost["flops"], cost["bytes"])
    return 100.0 * least / device_s
