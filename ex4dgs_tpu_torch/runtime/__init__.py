"""Host runtime: program spans, profiling and traces."""

from .profiling import trace  # noqa: F401
