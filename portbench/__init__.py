"""The benchmark of the PyTorch and CUDA port, ``fdtd2d_tpu_torch``.

``python3 -m portbench.run`` runs one cell of ``BENCHMARK.json`` once
(run.py). Layout, each file found by its name: ``configs/<config>.json``
(scene, physics, solver, precision, provenance), ``traffic/<traffic>.json``
(sizes, sources, request loop, check), ``drivers/<driver>.py`` (request
loops), ``scenes/<kind>.py`` (scene builders), ``metrics/<metric>.py`` (one
reader a metric), ``reference/`` (the plain references the check compares
with), ``control.py`` (the controls and readings that set the check's
limits), ``tests/``. Nothing here imports ``jax`` or the JAX package
``fdtd2d_tpu``.
"""
