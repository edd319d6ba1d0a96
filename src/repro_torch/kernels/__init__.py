"""Hand-written Hopper kernels, their plain PyTorch versions, and the ops
that choose between them by device (see ``ops.py``)."""
