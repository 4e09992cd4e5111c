"""Host runtime: profiling and step timing."""

from .profiling import StepTimer, trace  # noqa: F401
