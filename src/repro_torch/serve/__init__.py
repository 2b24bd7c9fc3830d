"""Serving: sparse packing, paging, the decode loop, the scheduler, the
drain engine and the ``LLM`` front door."""
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.serve.facade import LLM
from repro_torch.serve.scheduler import StreamRequest

__all__ = ["DecodeEngine", "LLM", "Request", "StreamRequest"]
