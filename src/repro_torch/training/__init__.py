"""Training: the optimizer, the train state and step, checkpoints."""
