"""Job state machine, config, batched analyzer, workers."""
from . import jobs  # noqa: F401
from .analyzer import Analyzer  # noqa: F401
from .config import EngineConfig, MetricPolicy, from_env  # noqa: F401
from .jobs import Document, HpaLog, JobStore, MetricQueries, to_external  # noqa: F401
from .scheduler import EngineWorker, StreamScheduler  # noqa: F401
