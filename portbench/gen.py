"""Inputs made from ``--seed``: H&E tiles on the device, and samples.

The tiles follow Beer-Lambert: I = Io exp(-(HE s) C), with torchstain's
default H&E basis, per-pixel uniform concentrations (haematoxylin in
[0.3, 2.1], eosin in [0.2, 1.2], as the numpy fixtures of the repository
draw them) and a stain scale ``s`` per tile and stain, drawn from the seed
in the configuration's ``stain_scale`` range, so each tile asks for its own
transform. They are made on the card by a ``torch.Generator`` in a few
large calls; the same seed and device give the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

IO = 240.0
HE_REF = ((0.5626, 0.2159), (0.7201, 0.8012), (0.4062, 0.5581))

_DTYPES = {"uint8": torch.uint8, "float32": torch.float32}


def seed_streams(seed: int, count: int) -> list[np.random.SeedSequence]:
    """``count`` independent seed streams of one run's ``--seed`` (any
    whole number)."""
    return np.random.SeedSequence(seed % 2**64).spawn(count)


def torch_generator(stream: np.random.SeedSequence, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(stream.generate_state(1, np.uint64)[0]))
    return gen


def tiles(n: int, tile: tuple[int, int, int], dtype: str, scale: tuple[float, float],
          gen: torch.Generator) -> torch.Tensor:
    """(n, 3, H, W) tiles on ``gen``'s device: uint8, or float32 in [0, 1]
    (the uint8 tile over 255, as a training pipeline's ``ToTensor`` gives)."""
    channels, h, w = tile
    if channels != 3:
        raise ValueError(f"H&E tiles have 3 channels, got {channels}")
    dev = gen.device
    u = torch.rand((n, 2, h * w), generator=gen, device=dev)
    conc_h = 0.3 + 1.8 * u[:, 0:1]
    conc_e = 0.2 + u[:, 1:2]
    s = scale[0] + (scale[1] - scale[0]) * torch.rand((n, 1, 2), generator=gen, device=dev)
    he = torch.tensor(HE_REF, device=dev)
    od = (he[None, :, 0:1] * s[:, :, 0:1]) * conc_h + (he[None, :, 1:2] * s[:, :, 1:2]) * conc_e
    out = (IO * torch.exp(-od)).clamp_(0.0, 255.0).to(torch.uint8).reshape(n, 3, h, w)
    if _DTYPES[dtype] == torch.float32:
        return out.to(torch.float32) / 255.0
    return out


def tile_batches(batches: int, n: int, tile, dtype: str, scale, gen: torch.Generator) -> list:
    """``batches`` distinct batches of ``n`` tiles, made one batch a call."""
    return [tiles(n, tile, dtype, scale, gen) for _ in range(batches)]


def sample(population: int, count: int, stream: np.random.SeedSequence) -> np.ndarray:
    """``count`` distinct indices below ``population`` (all when fewer),
    sorted."""
    count = min(count, population)
    return np.sort(np.random.default_rng(stream).choice(population, count, replace=False))
