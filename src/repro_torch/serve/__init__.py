from repro_torch.serve.engine import (  # noqa: F401
    ServeConfig, ServeEngine, SlotQueue, greedy_sample,
)
