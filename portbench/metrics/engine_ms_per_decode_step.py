"""The continuous engines' decode wall a token step: each group's wall a
fused macro-step (``t_per_macro_step_s``) over the macro-step's tokens,
weighted by the macro-steps it dispatched, over every wave served."""
LAYER, UNIT, SOURCE = "continuous engine", "ms", "program_span"
MOVES = "tokens_per_s"


def read(run):
    wall = steps = 0.0
    for tel in run.telemetry:
        k, m = tel["macro_steps"], tel["wave_steps"]
        for w in tel["waves"]:
            for g in w["per_group"].values():
                dispatches = g["wave_launches"] * m
                wall += g["t_per_macro_step_s"] * dispatches
                steps += dispatches * k
    return 1e3 * wall / steps if steps else None
