"""Plain PyTorch references of the benchmark's configurations: float32 with
TF32 off, no kernels, no caches, written from the published model
definitions (frozen copies of the port's plain model code where noted). They
import nothing of the program, of ``jax`` or of ``xpretrain_tpu``."""
