"""Small sizes of each cell for the CPU tests: the same code paths at a
few layers, narrow widths, short prompts and two slots a group."""
import numpy as np

CONFIGS = {
    "nemotron-4-15b.docqa": dict(num_layers=2, d_model=192, num_heads=6,
                                 num_kv_heads=2, head_dim=32, d_ff=384,
                                 vocab_size=512, dtype="float32"),
}
MIX = {"prompt_len": 256, "slots": 2,
       "output_len": {"median": 5, "sigma": 0.6,
                      "min": 2, "max": 12},
       "warm_max_new": 4, "check": {"min_tokens": 20, "max_requests": 4}}
CELLS = sorted(CONFIGS)
# At these sizes the port and the reference both compute in float32 and
# agree to 1e-4 of the largest logit (test_pb_reference.py), so a sound
# run's widest gap is a near-tie's, under 1e-5; the cells' own limits are
# set for bf16 against float32 at full size.
LIMITS = {"logit_gap": 1e-3}


def run(root, cell, seed=12345678901, seconds=0.3, traced=False, **kw):
    """One CPU run of ``cell`` at its small size."""
    import torch
    from portbench import harness
    torch.manual_seed(0)
    np.random.seed(0)
    kw.setdefault("limits_override", LIMITS)
    return harness.run_cell(root, cell, seed, seconds, traced, device="cpu",
                            look_for_chip=False, mix_override=MIX,
                            config_override=CONFIGS[cell], **kw)
