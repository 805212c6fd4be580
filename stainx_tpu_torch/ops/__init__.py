"""Tensor-level operations of the PyTorch port (counterpart of ``stainx_tpu.ops``)."""
