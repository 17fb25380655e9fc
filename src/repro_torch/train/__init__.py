"""Training: train-step factories, the trainer, checkpoints."""
