"""Sharded search and serving (port of ``repro/distributed``): the
series-sharded in-memory index and ``dist-ooc``, sharded out-of-core
serving of one saved index."""
from repro_torch.distributed.ooc import DistOutOfCoreBackend  # noqa: F401
from repro_torch.distributed.search import (  # noqa: F401
    StackedIndex, build_distributed_index, distributed_knn,
)
