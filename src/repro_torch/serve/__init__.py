"""Serving: sparse packing, paging, the scheduler and the ``LLM`` front door."""
from repro_torch.serve.facade import LLM
from repro_torch.serve.scheduler import StreamRequest

__all__ = ["LLM", "StreamRequest"]
