"""Model IO: PLY import/export and training checkpoints."""
