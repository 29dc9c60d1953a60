from . import timer, logging, serialization, profiler, device  # noqa: F401
