"""Training: optimizer, train step, data, checkpoints, fault tolerance."""
