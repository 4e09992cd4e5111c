"""Offline evaluation: metric suite and render harness."""
