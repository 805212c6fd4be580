"""The histogram-matching LUT apply (B8b): its launch shape and plane walk
on the CPU, and the kernel against its plain version on the card.

The CPU cases walk the kernel's loop in Python over :func:`apply_split`'s
launch shape: every value of every plane is looked up exactly once, by a
block of its own channel, within a plane, and each plane stretch splits
into a head, vectors on vector boundaries and a tail at any misalignment
(16 input bytes a vector for uint8 output, 4 for float32).
The card cases (``cuda`` marker) hold ``apply_lut`` and
``hm_transfer`` byte for byte against ``apply_lut_plain`` and
``hm_transfer_plain`` and read the ``lut.vector`` count of each launch.

The file imports no JAX, so on a card's machine it runs with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_lut_apply.py``."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from stainx_tpu_torch import kernels, profiling
from stainx_tpu_torch.kernels import histogram as hk

SMS = 132  # an H100's SMs


def _walk(n: int, c: int, p: int, bpc: int, chunk: int):
    """The plane stretches of an apply launch as (block, start, length),
    ``start`` a flat index into (N, C, P): the kernel's walk, in Python."""
    total = n * p
    for block in range(c * bpc):
        ch = block // bpc
        f = (block % bpc) * chunk
        end = min(f + chunk, total)
        if f >= end:
            continue
        img, pos = divmod(f, p)
        while f < end:
            length = min(p - pos, end - f)
            yield block, (img * c + ch) * p + pos, length
            f += length
            img += 1
            pos = 0


@pytest.mark.parametrize("p", [1, 15, 16, 17, 31, 32, 97 * 101, 384 * 384, 512 * 512])
@pytest.mark.parametrize("c", [1, 3, 130])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 256])
def test_apply_walk_covers_every_value_once(n, c, p):
    bpc, chunk = hk.apply_split(n, c, p, SMS)
    total = n * p
    assert chunk % 16 == 0 and hk.MIN_APPLY_VALUES <= chunk <= hk.APPLY_BLOCK_VALUES
    assert bpc >= 1 and bpc * chunk >= total and (bpc - 1) * chunk < max(total, 1)
    assert c * bpc <= kernels.MAX_GRID_X
    fill = hk.APPLY_BLOCKS_PER_SM * SMS
    if total >= hk.MIN_APPLY_VALUES * -(-fill // c):  # enough values to fill the card
        assert c * bpc >= fill

    blocks, starts, lengths = (np.array(a, dtype=np.int64) for a in zip(*_walk(n, c, p, bpc,
                                                                             chunk)))
    order = np.argsort(starts)
    starts, lengths, blocks = starts[order], lengths[order], blocks[order]
    # The stretches tile (N, C, P): no value missed, none looked up twice.
    assert starts[0] == 0 and starts[-1] + lengths[-1] == n * c * p
    assert np.array_equal(starts[1:], starts[:-1] + lengths[:-1]) and (lengths > 0).all()
    # Each stretch lies in one plane, of its block's channel.
    assert ((starts % p) + lengths <= p).all()
    assert np.array_equal((starts // p) % c, blocks // bpc)

    # A vector is 16 input bytes for uint8 output, 4 for float32 (one
    # 16-byte store either way).
    for width, misaligned in itertools.product((16, 4), range(16)):
        addr = misaligned + starts
        head = np.minimum((width - addr % width) % width, lengths)
        nvec = (lengths - head) // width
        tail = lengths - head - width * nvec
        assert (tail >= 0).all() and (tail < width).all() and (head < width).all()
        assert ((addr + head)[nvec > 0] % width == 0).all()
        if p >= 32:  # vector_aligned's rule: a plane this long holds a whole vector
            assert nvec.sum() > 0


@pytest.mark.parametrize("p", [16, 31, 32, 97 * 101])
@pytest.mark.parametrize("offset", range(16))
@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32])
def test_vector_aligned_reads_both_addresses(offset, p, out_dtype):
    """The vector walk runs where a 16-byte boundary of the input falls on
    one of the output and P ≥ 32: uint8 output at the input's offset
    modulo 16, float32 output at four times it."""
    n, c = 2, 3
    buf = torch.zeros(n * c * p + 64, dtype=torch.uint8)
    start = (offset - buf.data_ptr()) % 16
    values = buf[start:start + n * c * p].view(n, c, p)
    assert values.data_ptr() % 16 == offset
    out = torch.empty((n, c, p), dtype=out_dtype)
    assert out.data_ptr() % 16 == 0
    size = out.element_size()
    assert hk.vector_aligned(values, out) == ((size * offset) % 16 == 0 and p >= 32)


# ------------------------------------------------------------------- card
# (label, (N, C, P), byte offset of the input)
CARD_CASES = [
    ("cell 256x3x512^2", (256, 3, 512 * 512), 0),
    ("5x3x384^2", (5, 3, 384 * 384), 0),
    ("2x3x97x101, P not a multiple of 16", (2, 3, 97 * 101), 0),
    ("input at a 1-byte offset", (2, 3, 97 * 101), 1),
    ("input at a 4-byte offset", (2, 3, 97 * 101), 4),
    ("input at a 15-byte offset", (2, 3, 97 * 101), 15),
    ("C = 1", (3, 1, 384 * 384), 0),
    ("C = 130, the uint8 table in device memory", (2, 130, 4099), 0),
    ("N*C*P not a multiple of 16 x the unroll", (3, 3, 16437), 0),
]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B8b runs only there")
    return torch.device("cuda", 0)


def _values(shape, offset, dev, seed):
    n, c, p = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randint(0, 256, (n * c * p + 16,), generator=gen, device=dev, dtype=torch.uint8)
    values = buf[offset:offset + n * c * p].view(n, c, p)
    assert values.data_ptr() % 16 == offset
    return values


def _expect_vector(offset, p, out_dtype) -> int:
    size = torch.empty((), dtype=out_dtype).element_size()
    return int((size * offset) % 16 == 0 and p >= 32)


def _vector_count(fn):
    before = profiling.counters("lut.vector").get("lut.vector", 0)
    out = fn()
    torch.cuda.synchronize()
    return out, profiling.counters("lut.vector").get("lut.vector", 0) - before


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("label, shape, offset", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_apply_lut_on_the_card_is_the_plain_lookup(label, shape, offset, out_dtype):
    dev = _card()
    values = _values(shape, offset, dev, seed=29)
    c = shape[1]
    # Sorted entries past both ends of [0, 255]: the table's clip shows.
    lut = torch.sort(torch.rand((c, 256), generator=torch.Generator().manual_seed(c)) * 265.0
                     - 5.0, dim=1).values.to(dev)
    got, vectors = _vector_count(lambda: hk.apply_lut(values, lut, out_dtype))
    assert got.dtype == out_dtype
    assert torch.equal(got, hk.apply_lut_plain(values, lut, out_dtype)), label
    assert vectors == _expect_vector(offset, shape[2], out_dtype), label


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("label, shape, offset", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_hm_transfer_on_the_card_is_the_plain_transfer(label, shape, offset, out_dtype):
    dev = _card()
    values = _values(shape, offset, dev, seed=30)
    ref_hist = torch.rand((shape[1], 256), generator=torch.Generator().manual_seed(7)).to(dev)
    got, vectors = _vector_count(lambda: hk.hm_transfer(values, ref_hist, out_dtype))
    want = hk.hm_transfer_plain(values, ref_hist, out_dtype)
    for name, a, b in zip(("out", "lut", "table"), got, want):
        assert torch.equal(a, b), f"{label}: {name}"
    assert vectors == _expect_vector(offset, shape[2], out_dtype), label
