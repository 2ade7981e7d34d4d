from repro_torch.serve.engine import (  # noqa: F401
    KnnAnswer, KnnFailure, KnnServeConfig, KnnServeEngine, QueueFull,
    ServeConfig, ServeEngine, SlotQueue, greedy_sample,
)
