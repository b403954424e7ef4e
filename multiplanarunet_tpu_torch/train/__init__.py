"""Training: optimizers, train and eval steps, the Trainer."""
