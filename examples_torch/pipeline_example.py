"""Stain normalization inside a torch ``DataLoader`` training pipeline.

The port's counterpart of ``examples/pipeline_example.py`` and of
``examples/torch_pipeline_example.py``: a ``torch.utils.data.Dataset`` over
the committed H&E tiles (``examples/data/test_*.png``, decoded once by
``examples_torch/_png.py``) feeds ``DataLoader`` batches, collated to uint8
NCHW; each batch goes to the card as float [0, 1] and through
:class:`stainx_tpu_torch.StainNormalizerTransform`, an ``nn.Module``, in
reference mode (fit once on ``target.png``), which returns float [0, 1],
ready for a model. Then one batch-mode Reinhard step: re-fit on the batch's
first tile every call (exploratory use; intentionally mutable).

The loop is timed by the host's clock up to a synchronize: what a training
loop sees, the loader's collation and the copy to the card included (on
``--device cpu``, the kernels' plain versions).

Run::

    python examples_torch/pipeline_example.py [--batch 4] [--method macenko] [--epochs 2]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch
from torch.utils.data import DataLoader, Dataset

from examples_torch._common import DATA_DIR, add_device_argument, load_nchw
from stainx_tpu_torch import StainNormalizerTransform
from stainx_tpu_torch.utils import get_device


class TilesDataset(Dataset):
    """CHW uint8 tensors of the committed source tiles, repeated so a couple
    of epochs run several batches."""

    def __init__(self, repeat: int = 4):
        paths = sorted(p for p in glob.glob(os.path.join(DATA_DIR, "*.png"))
                       if os.path.basename(p) != "target.png")
        if not paths:
            raise SystemExit(f"no tiles under {DATA_DIR}: run examples/make_data.py")
        self.tiles = [torch.from_numpy(load_nchw(p)[0]) for p in paths] * repeat

    def __len__(self) -> int:
        return len(self.tiles)

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.tiles[i]


def main(argv=None) -> dict:
    """Run the pipeline; returns the last normalized batch, the batch-mode
    output and the rate."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--method", default="macenko",
                    choices=["macenko", "reinhard", "histogram_matching"])
    ap.add_argument("--epochs", type=int, default=2)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = get_device(args.device)

    reference = torch.from_numpy(load_nchw(os.path.join(DATA_DIR, "target.png")))
    normalize = StainNormalizerTransform(method=args.method, reference=reference.float() / 255.0,
                                         device=dev)
    loader = DataLoader(TilesDataset(), batch_size=args.batch, shuffle=False)

    def to_model_input(batch):  # uint8 NCHW from the loader -> float [0, 1] on the device
        return batch.to(dev).float() / 255.0

    normalize(to_model_input(next(iter(loader))))  # the first call on the card builds the kernels

    n_imgs = 0
    start = time.perf_counter()
    for _ in range(args.epochs):
        for batch in loader:
            out = normalize(to_model_input(batch))  # float [0, 1] in, float [0, 1] out
            n_imgs += out.shape[0]
            # ... the training step would consume `out` here ...
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - start
    print(f"{args.method}: {n_imgs} tiles ({tuple(batch.shape)} {batch.dtype} batches from the "
          f"DataLoader) in {elapsed:.3f} s ({n_imgs / elapsed:.1f} img/s on {dev}, collation and "
          f"the copy to the device included)")
    print(f"output: {tuple(out.shape)} {out.dtype} on {out.device}, range "
          f"[{float(out.min()):.3f}, {float(out.max()):.3f}]")

    batch_mode = StainNormalizerTransform(method="reinhard", mode="batch", device=dev)
    batch_out = batch_mode(to_model_input(batch))
    print(f"batch mode (reinhard, re-fit on batch[0]) out: {tuple(batch_out.shape)} "
          f"{batch_out.dtype}, range [{float(batch_out.min()):.3f}, {float(batch_out.max()):.3f}]")
    return {"last_batch": batch, "out": out, "batch_mode_out": batch_out,
            "img_per_s": n_imgs / elapsed, "images": n_imgs}


if __name__ == "__main__":
    main()
