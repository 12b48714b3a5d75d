from .cache import BlockManager, PagedKVCache, init_paged_cache
from .continuous_api import (
    ContinuousBatchingEngine,
    ContinuousBatchingManager,
    ContinuousMixin,
    GenerationOutput,
)
from .model_runner import ModelRunner, PagedCacheView
from .sampling import RowSampling, sample_tokens
from .scheduler import (
    FIFOScheduler,
    PrefillFirstScheduler,
    RequestState,
    RequestStatus,
    SchedulerOutput,
)
