"""Helpers shared by the HD-VILA parity tests (``tests/test_torch_hdvila*.py``).

The JAX side is built from shapes alone: ``jax.eval_shape`` of a module's
init gives its param tree, and :func:`random_params` fills it from a numpy
seed (a jitted init of the tiny encoder costs seconds of compile on the CPU,
its shapes a fraction of one). Applies run jitted, for the same reason.
"""

import numpy as np

TOL = 1e-4  # PARITY.md's HD-VILA bar, fp32


def random_params(module, *args, seed: int = 0, method=None, **kwargs) -> dict:
    """Seeded numpy params for ``module`` at the shapes its init gives for
    ``args``: kernels N(0, 1/fan_in), frozen-BN and layer-norm scales 1 +
    N(0, 0.02^2), BN variances in [1, 1.1], embeddings N(0, 1/features),
    everything else (biases, BN means, position and time embeddings, the
    visual token-type embedding) N(0, 0.02^2)."""
    import jax

    shapes = jax.eval_shape(lambda r: module.init(r, *args, method=method, **kwargs), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.02 * rng.normal(size=shape)
        if name == "var":
            return 1.0 + 0.1 * rng.random(size=shape)
        if name == "embedding":
            return rng.normal(size=shape) / np.sqrt(shape[-1])
        return 0.02 * rng.normal(size=shape)

    params = jax.tree_util.tree_map_with_path(leaf, shapes["params"])
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)


def jit_apply(module, method=None, **static):
    """``f(params, *args)`` = ``module.apply({"params": params}, *args,
    method=method, **static)``, jitted."""
    import jax

    return jax.jit(lambda p, *args: module.apply({"params": p}, *args, method=method, **static))


def assert_close(got, want, what: str = "", tol: float = TOL) -> None:
    """Within ``tol`` of max(1, max|want|)."""
    import torch

    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())), err_msg=what)
