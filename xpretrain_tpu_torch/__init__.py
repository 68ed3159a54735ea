"""xpretrain_tpu_torch: the PyTorch + CUDA port of ``xpretrain_tpu``.

Module paths mirror the JAX package, so each counterpart sits at the same
path. Plain tensor code is PyTorch; every kernel the JAX package wrote in
Pallas for the TPU is a kernel written by hand for NVIDIA Hopper, under
``csrc/``, built at first use (``ops/_kernels.py``). The package imports
nothing of JAX nor of the JAX package: its host layer (config, CLI flags,
data, tokenization, metrics, retrieval evaluation) is its own copy, under the
same module paths.
"""

__version__ = "0.1.0"
