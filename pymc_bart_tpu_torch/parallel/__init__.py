"""Chain and row parallelism over ``torch.distributed`` processes."""
