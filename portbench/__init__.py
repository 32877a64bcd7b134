"""The benchmark of the PyTorch and CUDA port (``skypilot_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel count is a file of its own under this directory, found
by the name ``BENCHMARK.json`` gives it (``spec.py``). The harness drives
the port only; nothing here imports ``jax`` or the JAX package.
"""
