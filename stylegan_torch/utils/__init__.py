"""Utilities: the run logger, the source snapshot, metrics and step timing."""

from .logger import make_logger
from .profiling import MetricsWriter, StepTimer
from .snapshot import snapshot_sources

__all__ = ["make_logger", "snapshot_sources", "MetricsWriter", "StepTimer"]
