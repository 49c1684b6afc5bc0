"""Utilities: the run logger, the source snapshot, metrics, spans and
counters, profiler traces and FLOP counts (``utils.flops``)."""

from .logger import make_logger
from .profiling import MetricsWriter, counters, recording, span, trace
from .snapshot import snapshot_sources

__all__ = ["make_logger", "snapshot_sources", "MetricsWriter", "counters",
           "recording", "span", "trace"]
