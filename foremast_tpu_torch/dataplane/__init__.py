"""Data plane: query construction, fetching, verdict export (the delta and
window-store sources are not ported yet)."""
from .exporter import VerdictExporter  # noqa: F401
from .fetch import (  # noqa: F401
    CachingDataSource,
    FetchError,
    FixtureDataSource,
    PrometheusDataSource,
    WavefrontDataSource,
)
from .promql import (  # noqa: F401
    MetricQuerySpec,
    MetricWindows,
    build_metric_windows,
    materialize_placeholders,
    pod_count_url,
)
