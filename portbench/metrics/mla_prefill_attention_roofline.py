"""The MLA prefill attention's share of its roofline over the traced
batch: the least time of each prefilled prompt's causal attention with the
latent expanded (q/k 192 and v 128 wide, every layer, by the frozen
``families/mla_moe.py:prefill_attention_cost``) over the device time of
every operation launched inside the benchmark's span around
``repro_torch.models.attention.mla_prefill_attend``."""
from portbench import trace, yardstick

LAYER, UNIT, SOURCE = "kernels", "%", "device_trace"
MOVES = "ttft_p90_ms"
SPAN = ("repro_torch.models.attention", "mla_prefill_attend")


def read(run):
    device_s = trace.device_seconds(run.trace, SPAN[1])
    cost = getattr(run.family, "prefill_attention_cost", None)
    if device_s is None or cost is None:
        return None
    c = run.sizes
    esize = 2 if c.dtype == "bfloat16" else 4
    least = 0.0
    for r in run.requests.values():
        if r.tokens is None or r.batch not in run.traced_batches:
            continue
        w = cost(r.prompt_len, c.num_attention_heads,
                 c.qk_nope_head_dim + c.qk_rope_head_dim, c.v_head_dim, esize)
        least += c.num_hidden_layers * yardstick.roofline_seconds(
            w["flops"], w["bytes"])
    return 100.0 * least / device_s
