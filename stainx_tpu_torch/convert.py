"""Carrying fitted state across from the JAX package.

A reference fitted with ``stainx_tpu`` (its ``state`` dict, or the ``.npz``
file its ``save_state`` writes) becomes the port's tensors, so
``stainx_tpu_torch.Macenko().load_state(state_from_jax(...))`` gives the
same transform, and likewise for ``Reinhard`` and ``HistogramMatching``.
Reads numpy arrays only: JAX is not imported.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from stainx_tpu_torch.utils import get_device


def state_from_jax(
    state: dict[str, Any] | str | os.PathLike, device: str | torch.device | None = None
) -> dict[str, torch.Tensor]:
    """Fitted state of a ``stainx_tpu`` normalizer as float32 tensors on
    ``device`` (default ``cuda:0``). ``state`` is the JAX normalizer's
    ``state`` dict (numpy or JAX arrays) or a path to its ``save_state``
    ``.npz``. Keys are kept as they are (Macenko: ``_stain_matrix``,
    ``_target_max_conc``; Reinhard: ``_reference_mean``,
    ``_reference_std``; HistogramMatching: ``_ref_histograms_256``), and
    entries that are ``None`` are dropped."""
    if isinstance(state, (str, os.PathLike)):
        with np.load(state) as data:
            state = {k: data[k] for k in data.files}
    dev = get_device(device)
    return {
        k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
        for k, v in state.items()
        if v is not None
    }
