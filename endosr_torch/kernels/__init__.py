"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version
(counterpart of ``endosr.kernels``)."""
