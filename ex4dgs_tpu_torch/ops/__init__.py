"""Per-Gaussian and per-tile compute: math, projection, binning, compositing."""
