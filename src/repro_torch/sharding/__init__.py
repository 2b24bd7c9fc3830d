"""Tensor- and expert-parallel decode math (``tensor_parallel``); the
training mesh (``mesh``), partition specs (``specs``, ``autoshard``) and
the shard-explicit collectives (``collectives``)."""
from repro_torch.sharding import tensor_parallel

__all__ = ["tensor_parallel"]
