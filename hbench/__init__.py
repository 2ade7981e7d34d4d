"""The benchmark of ``repro_torch``: exact k-NN served on one CUDA card.

``python3 hbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON result
line. Everything that belongs to one configuration, traffic mix, metric
or kernel lives in a file of its own, found by name:

* ``configs/<name>.json``  -- a deployment (collection, backend, search);
* ``builders/<name>.py``   -- how a configuration's backend is built, ``build()``;
* ``traffic/<name>.json``  -- a query mix (clients, k, hardness);
* ``metrics/<name>.py``    -- a metric's reader, ``read(ctx)``;
* ``roofline/<kernel>.py`` -- a kernel's bytes and operations a launch.

Nothing here imports ``jax`` or the JAX package ``repro``; ``reference.py``
imports nothing of ``repro_torch`` either.
"""
