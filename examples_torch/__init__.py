"""User programs of the PyTorch / CUDA port (``stainx_tpu_torch``).

The counterparts of ``examples/``, which run the JAX package, under the
same names: ``simple_example``, ``visualize_example``, ``pipeline_example``
(which also stands for ``examples/torch_pipeline_example.py``),
``serving_example`` and ``quickstart_notebook.ipynb``. Each script runs as
``python examples_torch/<script>.py`` from the repository's root, on
``cuda:0`` by default (``--device cpu`` runs the kernels' plain versions,
and without CUDA the default device raises), and imports no JAX, PIL or
matplotlib: the committed tiles are read and the panels written by
:mod:`examples_torch._png`.
"""
