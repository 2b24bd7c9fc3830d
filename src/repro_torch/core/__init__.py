"""Dispatch rules, serving plan and the block-sparse format."""
