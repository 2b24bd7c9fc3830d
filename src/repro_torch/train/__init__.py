from repro_torch.train import loop, optimizer

__all__ = ["loop", "optimizer"]
