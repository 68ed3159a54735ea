"""Port parity: the MoE FFN (``xpretrain_tpu_torch/parallel/moe.py``) against
the JAX package's ``MoeFfn`` (``tests/test_moe.py``'s shapes), in one
process, fp32 on the CPU, from JAX's parameters (``moe_params_from_flax``,
key for key): outputs ≤ 2e-5, ``aux`` ≤ 1e-6 relative, gradients ≤
2e-5·max|g| of each leaf, top-1 and top-2, at ample capacity and with tokens
dropped; ``_topk_dispatch``'s masks equal to JAX's; every expert trained.
Also: both packages' ``parallel`` and ``ops`` export the same names. The
data 2 × expert 2 case runs in ``tests/test_torch_seq_pipe_expert.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import xpretrain_tpu.ops as jax_ops  # noqa: E402
import xpretrain_tpu.parallel as jax_parallel  # noqa: E402
from xpretrain_tpu.parallel import moe as jmoe  # noqa: E402
import xpretrain_tpu_torch.ops as port_ops  # noqa: E402
import xpretrain_tpu_torch.parallel as port_parallel  # noqa: E402
from xpretrain_tpu_torch.parallel import moe  # noqa: E402

T, D, E, F = 24, 16, 4, 32


def _jax_case(k: int, capacity_factor: float, seed: int = 0, tokens: int = T):
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed + 1), (tokens, D), jnp.float32))
    model = jmoe.MoeFfn(num_experts=E, d_ff=F, num_selected=k, capacity_factor=capacity_factor)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), x)
    params = jax.tree_util.tree_map(np.asarray, params)
    return model, params, x


def _port(params, k: int, capacity_factor: float) -> moe.MoeFfn:
    port = moe.MoeFfn(D, E, F, num_selected=k, capacity_factor=capacity_factor)
    port.load_state_dict(moe.moe_params_from_flax(params))
    return port


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("capacity_factor", [8.0, 0.75], ids=["ample", "drops"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_matches_jax(k, capacity_factor):
    """Outputs, ``aux`` and the gradients of ``mean(y**2) + 0.01·aux``."""
    model, params, x = _jax_case(k, capacity_factor)

    def loss_fn(p):
        y, aux = model.apply(p, x)
        return jnp.mean(y**2) + 0.01 * aux, (y, aux)

    (_, (want_y, want_aux)), want_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = _port(params, k, capacity_factor)
    y, aux = port(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=2e-5, atol=2e-5)
    assert abs(aux.item() / float(want_aux) - 1) <= 1e-6
    capacity = max(1, int(np.ceil(k * T / E * capacity_factor)))
    routed = jmoe._topk_dispatch(jax.nn.softmax(x @ params["params"]["router"]), k, capacity)[0]
    assert (float(routed.sum()) < T * k) == (capacity_factor < 1)  # JAX drops tokens where the case says so
    ((y**2).mean() + 0.01 * aux).backward()
    for name, p in port.named_parameters():
        want = np.asarray(want_g["params"][name])
        assert _rel(p.grad.numpy(), want) <= 2e-5, (name, _rel(p.grad.numpy(), want))


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 6), (2, 2), (3, 4)])
def test_topk_dispatch_masks_equal_jax(k, capacity):
    """Masks equal to JAX's, bit for bit, where the capacity drops tokens."""
    probs = np.array(jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(3), (12, E))))
    want_d, want_c = jax.jit(jmoe._topk_dispatch, static_argnums=(1, 2))(probs, k, capacity)
    got_d, got_c = moe._topk_dispatch(torch.from_numpy(probs), k, capacity)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_d.sum() < 12 * k  # some tokens dropped
    want_aux = jmoe.load_balance_loss(probs, want_d)
    got_aux = moe.load_balance_loss(torch.from_numpy(probs), got_d)
    assert abs(got_aux.item() / float(want_aux) - 1) <= 1e-6


def test_all_experts_receive_gradients():
    """JAX's check: with balanced random routing every expert's weights and
    the router train."""
    _, params, x = _jax_case(1, 2.0, seed=4, tokens=64)
    port = _port(params, 1, 2.0)
    y, aux = port(torch.from_numpy(x))
    ((y**2).mean() + 0.01 * aux).backward()
    assert (port.w1.grad.abs().sum(dim=(1, 2)) > 0).all()
    assert (port.w2.grad.abs().sum(dim=(1, 2)) > 0).all()
    assert port.router.grad.abs().sum() > 0


def test_moe_pspec_matches_jax():
    _, params, _ = _jax_case(1, 1.25)
    for name, leaf in params["params"].items():
        want = tuple(jmoe.moe_pspec(f"params/{name}", leaf.shape))
        assert moe.moe_pspec(f"params/{name}", leaf.shape) == want
        assert moe.moe_pspec(f"ffn.{name}", leaf.shape) == want


def test_moe_param_shardings_give_the_rank_its_experts():
    """JAX's ``moe_param_shardings`` splits the expert leaves over
    ``expert``; the port's gives a rank its block (rank 1 of 2 here: experts
    2 and 3) and the router whole."""
    from xpretrain_tpu_torch.parallel.mesh import DataMesh

    state = moe.moe_params_from_flax(_jax_case(1, 1.25)[1])
    mesh = DataMesh(rank=0, world_size=1, device=torch.device("cpu"), backend="gloo", model_rank=1, model_size=2,
                    model_axis="expert")
    got = moe.moe_param_shardings(state, mesh)
    assert torch.equal(got["router"], state["router"])
    for name in ("w1", "b1", "w2", "b2"):
        assert torch.equal(got[name], state[name][E // 2:]), name


def test_bf16_compute_casts_at_use():
    """``dtype`` bf16: fp32 parameters, a bf16 output near the fp32 one."""
    _, params, x = _jax_case(2, 8.0)
    port = _port(params, 2, 8.0)
    port16 = moe.MoeFfn(D, E, F, num_selected=2, capacity_factor=8.0, dtype=torch.bfloat16)
    port16.load_state_dict(port.state_dict())
    assert all(p.dtype == torch.float32 for p in port16.parameters())
    y, _ = port(torch.from_numpy(x))
    y16, _ = port16(torch.from_numpy(x))
    assert y16.dtype == torch.bfloat16
    np.testing.assert_allclose(y16.float().detach().numpy(), y.detach().numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("pkg", ["parallel", "ops"])
def test_the_port_exports_every_jax_name(pkg):
    jax_pkg, port_pkg = {"parallel": (jax_parallel, port_parallel), "ops": (jax_ops, port_ops)}[pkg]
    missing = sorted(set(jax_pkg.__all__) - set(port_pkg.__all__))
    assert not missing, missing
    assert all(hasattr(port_pkg, name) for name in port_pkg.__all__)
