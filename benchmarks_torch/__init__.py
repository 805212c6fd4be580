"""Measuring scripts of the PyTorch / CUDA port (``stainx_tpu_torch``).

The counterparts of ``bench.py`` and ``benchmarks/``, which time the JAX
package: ``bench_batch_mode``, ``bench_serving``, ``benchmark_grid`` and
``correctness_report``, on the shared protocol of :mod:`benchmarks_torch.utils`.
Each runs as ``python -m benchmarks_torch.<script>`` from the repository's
root, on ``cuda:0`` by default (``--device cpu`` runs the kernels' plain
versions), and imports no JAX.
"""
