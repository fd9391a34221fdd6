"""Training: AdamW (``optimizer``), the train step and loop (``train``) and
``.npz`` checkpoints in the JAX package's layout (``checkpoint``)."""
