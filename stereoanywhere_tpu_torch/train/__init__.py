"""Training: the loss stack, its unused auxiliary losses and the trainer."""
