"""Lane-batched sweeps."""
