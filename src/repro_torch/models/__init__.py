"""Decoder layers, layout and the decode/prefill paths."""
