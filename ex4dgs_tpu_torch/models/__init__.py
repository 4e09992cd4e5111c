"""Gaussian model state, configuration and temporal queries."""
