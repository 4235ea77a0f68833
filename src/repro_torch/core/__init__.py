"""The Tool, the batched DSE engine, §IV.A and Algorithm II on PyTorch."""
