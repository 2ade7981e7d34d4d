"""The Hercules index on PyTorch: summaries, tree build, layout, exact kNN
search and the query engine (port of ``repro.core``)."""
