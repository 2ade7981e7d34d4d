"""The Hercules index on PyTorch: summaries, tree build, layout, exact kNN
search and the query engine (port of ``repro.core``)."""
from repro_torch.core.search import (  # noqa: F401
    KnnResult, SearchConfig, approx_knn, brute_force_knn, exact_knn, pscan_knn,
    validate_runtime_config, wave_knn,
)
