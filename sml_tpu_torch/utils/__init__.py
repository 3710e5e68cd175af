"""Engine counters and timing spans."""
from .profiler import PROFILER, start_device_trace

__all__ = ["PROFILER", "start_device_trace"]
