"""Multi-rank execution on ``torch.distributed``: collectives on a mesh axis
with their byte counter, and a launcher of N ranks for tests and smoke runs."""
