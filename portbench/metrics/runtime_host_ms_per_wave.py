"""The fleet runtime's own host time a wave: each served wave's wall less
the walls of its groups' engines (``ServeResult`` telemetry), averaged
over every wave the run served."""
LAYER, UNIT, SOURCE = "fleet runtime", "ms", "program_span"
MOVES = "tokens_per_s"


def read(run):
    waves = run.waves
    if not waves:
        return None
    own = [w["wall_s"] - sum(g["wall_s"] for g in w["per_group"].values())
           for w in waves]
    return 1e3 * sum(own) / len(own)
