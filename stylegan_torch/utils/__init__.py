"""Utilities: the run logger, the source snapshot, metrics, step timing,
profiler traces and FLOP counts (``utils.flops``)."""

from .logger import make_logger
from .profiling import MetricsWriter, StepTimer, trace
from .snapshot import snapshot_sources

__all__ = ["make_logger", "snapshot_sources", "MetricsWriter", "StepTimer",
           "trace"]
