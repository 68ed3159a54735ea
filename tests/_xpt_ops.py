"""The port's ``xpt::`` custom ops on CPU tensors, for the tests that run the
kernels' CUDA branches on the CPU with the launches replaced by their plain
versions (a kernel has no CPU mode). Outside :func:`xpt_ops_on_cpu` the ops
are registered for CUDA only, and a CPU tensor reaching one raises."""

import contextlib

import torch


@contextlib.contextmanager
def xpt_ops_on_cpu():
    """While inside, each ``xpt::`` op takes CPU tensors too, through its real
    body (``_fwd_launch``, ``_bwd_launch``, ``_window_launch``,
    ``_patch_launch``, and ``frozen_bn``'s two), whose ``_kernels`` launch
    the test replaces."""
    from xpretrain_tpu_torch.ops import frozen_bn, patchify, proxy_attention, window_attention

    with torch.library._scoped_library("xpt", "IMPL") as lib:
        lib.impl("proxy_attention_fwd", proxy_attention._fwd_launch, "CPU")
        lib.impl("proxy_attention_bwd", proxy_attention._bwd_launch, "CPU")
        lib.impl("window_attention_fwd", window_attention._window_launch, "CPU")
        lib.impl("patch_embed_u8", patchify._patch_launch, "CPU")
        lib.impl("frozen_bn_act_fwd", frozen_bn._fwd_launch, "CPU")
        lib.impl("frozen_bn_act_bwd", frozen_bn._bwd_launch, "CPU")
        yield
