"""xpretrain_tpu_torch: the PyTorch + CUDA port of ``xpretrain_tpu``.

Module paths mirror the JAX package, so each counterpart sits at the same
path. Plain tensor code is PyTorch; every kernel the JAX package wrote in
Pallas for the TPU is a kernel written by hand for NVIDIA Hopper, under
``csrc/``, built at first use (``ops/_kernels.py``). The package imports no
JAX; it reuses the JAX package's framework-free modules (config, data,
tokenization, metrics, retrieval evaluation).
"""

__version__ = "0.1.0"
