"""Tensor- and expert-parallel decode math (``tensor_parallel``)."""
from repro_torch.sharding import tensor_parallel

__all__ = ["tensor_parallel"]
