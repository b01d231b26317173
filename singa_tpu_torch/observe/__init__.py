"""Host-side observability: spans (``trace``) and counters (``registry``)."""

from . import registry, trace  # noqa: F401
