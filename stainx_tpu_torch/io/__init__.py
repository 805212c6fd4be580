"""Host-side tile ingest for the card (native C++ readers).

Counterpart of ``stainx_tpu/io``: a threaded C++ reader
(:mod:`~stainx_tpu_torch.io.tilepipe`) fills pre-allocated batch buffers
from raw tile files while the previous batch computes on the card, and a
page-locked stage copies each batch to the card. Importing this package
builds nothing; the first loader or pipe builds the reader's library.

Usage::

    from stainx_tpu_torch.io import RawTileLoader

    loader = RawTileLoader(paths, tile_shape=(3, 512, 512), batch_size=64)
    for batch in loader:          # (B, 3, H, W) uint8 on cuda:0, the caller's
        out = normalizer.transform(batch)
"""

from stainx_tpu_torch.io.tilepipe import RawTileLoader, TilePipe, tilepipe_available

__all__ = ["RawTileLoader", "TilePipe", "tilepipe_available"]
