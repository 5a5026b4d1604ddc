"""repro_torch.metrics — scalar metric logging (counterpart of
`repro.metrics`): the resume-safe per-round `CSVLogger`, the windowed
`MetricTracker`, and the telemetry registry's instrument types."""
from repro_torch.metrics.logging import CSVLogger, MetricTracker
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["CSVLogger", "MetricTracker",
           "Counter", "Gauge", "Histogram", "MetricsRegistry"]
