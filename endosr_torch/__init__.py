"""endosr_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``endosr``.

The JAX package ``endosr`` is the reference; this package mirrors its
module tree (``nn``, ``ops``, ``kernels``, ``models``, ``utils``) so each
ported function sits where its counterpart sits. It imports ``torch`` and
``numpy`` only — never JAX, flax, optax or anything under ``endosr``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a CUDA device and without an explicit device they raise. The hand-written
CUDA kernels under ``csrc/`` are built with ``nvcc`` at first use into
``build/endosr_torch/`` (see ``kernels/_build.py``).
"""

__version__ = "0.1.0"
