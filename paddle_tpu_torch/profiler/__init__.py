"""Host-span profiling: :class:`RecordEvent` and the process collector
the observability hooks feed (:mod:`.profiler`)."""
from .profiler import RecordEvent  # noqa: F401
