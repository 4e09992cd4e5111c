"""Offline dataset preparation: frame extraction and known-pose COLMAP
triangulation pipelines for N3V and Technicolor captures.

Counterpart of `ex4dgs_tpu/preprocess/`: numpy, sqlite and subprocess code
(no torch), kept in the port so that it imports nothing of the JAX
package."""
