"""TridentServe on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The package mirrors ``repro``'s layout (``kernels/``, ``models/``,
``configs/``, ``core/``, ``launch/``) so each module's counterpart is easy to
find. It imports ``torch`` and never ``jax`` or ``repro``. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""
