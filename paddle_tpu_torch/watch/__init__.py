"""paddle_tpu_torch.watch: the analysis layer over the telemetry stack (a
copy of ``paddle_tpu.watch``).

``observability`` + ``tracing`` collect; ``watch`` interprets:

- :mod:`~paddle_tpu_torch.watch.detectors` — shared online anomaly detector
  cores (EWMA z-score, rolling quantile, spatial/temporal skew);
- :mod:`~paddle_tpu_torch.watch.alerts` — structured alert fan-out (runlog,
  ``watch.alert.*`` metrics, warn-once, ``/alerts``, actions);
- :mod:`~paddle_tpu_torch.watch.slo` — declarative SLOs with multi-window
  burn rates and error budgets, served at ``/slo``;
- :mod:`~paddle_tpu_torch.watch.watcher` — registry-subscription glue binding
  detectors and SLO engines to live metric streams;
- :mod:`~paddle_tpu_torch.watch.baseline` — persistent perf baselines with
  noise-band verdicts.
"""

from paddle_tpu_torch.watch.alerts import (  # noqa: F401
    Alert,
    AlertHub,
    CRITICAL,
    WARNING,
    default_hub,
)
from paddle_tpu_torch.watch.baseline import (  # noqa: F401
    BaselineKey,
    BaselineStore,
    RollingStat,
    metric_direction,
)
from paddle_tpu_torch.watch.detectors import (  # noqa: F401
    DetectorResult,
    EwmaDetector,
    RollingQuantileDetector,
    SkewDetector,
)
from paddle_tpu_torch.watch.slo import (  # noqa: F401
    SLO,
    SloEngine,
    disagg_slos,
    install,
    installed_engines,
    serving_slos,
    uninstall,
)
from paddle_tpu_torch.watch.watcher import (  # noqa: F401
    MetricWatcher,
    WatchConfig,
    WatchRule,
    build,
    default_rules,
)

__all__ = [
    "Alert",
    "AlertHub",
    "WARNING",
    "CRITICAL",
    "default_hub",
    "BaselineKey",
    "BaselineStore",
    "RollingStat",
    "metric_direction",
    "DetectorResult",
    "EwmaDetector",
    "RollingQuantileDetector",
    "SkewDetector",
    "SLO",
    "SloEngine",
    "disagg_slos",
    "install",
    "installed_engines",
    "serving_slos",
    "uninstall",
    "MetricWatcher",
    "WatchConfig",
    "WatchRule",
    "build",
    "default_rules",
]
