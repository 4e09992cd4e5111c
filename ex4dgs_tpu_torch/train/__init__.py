"""Training: one step of render, loss, backward, RAdam and stat accumulators."""
