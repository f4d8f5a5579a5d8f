"""repro_torch.serve — the serving layer of the port (``repro.serve``):
EDF batching, the reader-writer lock, engine metrics, pipelined search,
the out-of-process compactor, :class:`RetrievalEngine`, the kNN-LM
:class:`RetrievalStore` and the LM decode scheduler
(:class:`ContinuousBatchingEngine`)."""

from repro_torch.serve.batching import (  # noqa: F401
    BatchPlan,
    effective_deadline,
    form_batch,
)
from repro_torch.serve.compactor import (  # noqa: F401
    CompactionChildError,
    compact_in_child,
)
from repro_torch.serve.engine import (  # noqa: F401
    DeadlineExceeded,
    EngineClosed,
    EngineDegraded,
    MaintenancePolicy,
    MaintenanceTimeout,
    QueueFull,
    RetrievalEngine,
    SearchTicket,
)
from repro_torch.serve.metrics import (  # noqa: F401
    EngineMetrics,
    LatencyRecorder,
    percentiles,
)
from repro_torch.serve.pipeline import pipelined_search  # noqa: F401
from repro_torch.serve.retrieval import RetrievalStore, knn_lm_mix  # noqa: F401
from repro_torch.serve.rwlock import ReadWriteLock  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    ContinuousBatchingEngine,
    Request,
    knn_lm_sampler,
)
