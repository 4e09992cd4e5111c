"""Scene/data layer: COLMAP parsing, dataset readers, cameras, orchestration."""
