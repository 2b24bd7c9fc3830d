"""Runtime helpers shared by serving and (later) training."""
