"""Swin3D context parallelism (``--cp``) in the port, on the CPU.

JAX's tiny config of ``tests/test_context_parallel.py`` (T = 8 frames,
temporal windows 2 -> 8, so the first stages are shard-local and the last
windows span the shards) runs through the port's time-sharded encoder at
cp = 2 and 4 (``tests/_torch_mp_worker.py``'s ``swin_cp``, gloo groups of 2
and 4 ranks). Its outputs, global and local branch, are held to the JAX
package's unsharded forward at 5e-5, and the gradients of one backward
(summed over the model group, as the train step sums them) to the
one-process port. ``run_pretrain_lfvila --cp 2`` runs through the runner on
2 ranks and equals the same runner on one rank.
"""

import json
import os
import shutil
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)

from test_torch_data_parallel import _spawn, _wait  # noqa: E402

from xpretrain_tpu_torch.models.lf_vila import swin3d  # noqa: E402

TINY = dict(depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2), stages=(0, 0, 1, 1), downsample_stages=(1,),
            window_size=((2, 2, 2), (4, 2, 2), (8, 2, 2), (8, 2, 2)), local_window=4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _jax_forward(root: str) -> dict:
    """JAX's unsharded forward of the tiny encoder, both local-branch modes;
    writes the parameters and the video for the workers."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.models.lf_vila.swin3d import Swin3DConfig, SwinTransformer3D

    video = np.random.default_rng(0).normal(size=(2, 3, 8, 32, 32)).astype(np.float32)
    base = SwinTransformer3D(Swin3DConfig.tiny(**TINY))
    params = base.init(jax.random.PRNGKey(0), jnp.asarray(video))
    flat = {"p/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    np.savez(os.path.join(root, "swin_cp.npz"), video=video, **flat)
    out = {}
    for tag, faithful in (("faithful", True), ("local", False)):
        model = SwinTransformer3D(Swin3DConfig.tiny(faithful_local_branch=faithful, **TINY))
        g, loc = jax.jit(lambda p, v: model.apply(p, v))(params, jnp.asarray(video))
        out[tag] = (np.asarray(g), np.asarray(loc))
    return out


@pytest.fixture(scope="module")
def runs():
    root = tempfile.mkdtemp(prefix="xpt_cp_")
    jax_out = _jax_forward(root)
    names = {2: ("swin_cp", "lfvila_runner_cp"), 4: ("swin_cp",), 1: ("lfvila_runner_cp",)}
    spawns = {world: _spawn(os.path.join(root, f"w{world}"), world, cases) for world, cases in names.items()}
    results = {}
    for world, spawn in spawns.items():
        _wait(spawn)
        results[world] = {n: [json.load(open(os.path.join(root, f"w{world}", f"{n}_{r}.json"))) for r in range(world)]
                          for n in names[world]}
    yield {"root": root, "results": results, "jax": jax_out}
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("tag", ["faithful", "local"])
def test_sharded_forward_matches_jax_unsharded(runs, cp, tag):
    got = np.load(os.path.join(runs["root"], f"w{cp}", "swin_cp", f"{tag}.npz"))
    want_g, want_l = runs["jax"][tag]
    np.testing.assert_allclose(got["glob"], want_g, atol=5e-5, rtol=0)
    np.testing.assert_allclose(got["loc"], want_l, atol=5e-5, rtol=0)
    for rank in runs["results"][cp]["swin_cp"]:
        assert rank["model_size"] == cp
        # every model rank returns the gathered output, equal to one process's
        assert rank[f"{tag}_fwd_vs_one_process"] < 5e-5


@pytest.mark.parametrize("cp", [2, 4])
def test_gradients_match_one_process(runs, cp):
    """The partial gradients of the rank's frames, summed over the model
    group, are the one-process gradients (largest difference relative to the
    leaf's largest gradient)."""
    for rank in runs["results"][cp]["swin_cp"]:
        for tag in ("faithful", "local"):
            assert rank[f"{tag}_grad"] < 5e-5, (tag, rank[f"{tag}_grad"])


def test_runner_cp2_equals_one_rank(runs):
    """The runner on a (1, 2) mesh (time over the model axis; one data
    index, so the draws of one process) against the runner on one rank."""
    (r0, r1) = runs["results"][2]["lfvila_runner_cp"]
    (one,) = runs["results"][1]["lfvila_runner_cp"]
    assert (r0["cp"], r0["model_size"], r1["model_size"], one["cp"]) == (2, 2, 2, 1)

    def by_tag(rows):
        out: dict = {}
        for row in rows:
            out.setdefault(row["tag"], []).append(row["value"])
        return out

    cp2, cp1 = by_tag(r0["scalars"]), by_tag(one["scalars"])
    for key in ("loss", "ct_global_loss", "ct_time_loss", "grad_norm"):
        assert len(cp2[f"train/{key}"]) == len(cp1[f"train/{key}"]) == 2, key
        np.testing.assert_allclose(cp2[f"train/{key}"], cp1[f"train/{key}"], rtol=5e-5, atol=5e-5, err_msg=key)


def test_local_blocks_follow_the_window_and_the_shift():
    """cp = 2 over T = 8: windows 2 and 4 tile the 4 local frames; window 8
    spans both shards. cp = 4: only window 2 is local. A temporal shift is
    never local."""
    model = swin3d.SwinTransformer3D(swin3d.Swin3DConfig.tiny(**TINY))
    blocks = [getattr(model, f"layers_{i}_blocks_0") for i in range(4)]
    dims = (8, 4, 4)
    assert [model.runs_local(b, dims, 2) for b in blocks] == [True, True, False, False]
    assert [model.runs_local(b, dims, 4) for b in blocks] == [True, False, False, False]
    shifted = swin3d.SwinBlock3D(32, 2, (2, 2, 2), (1, 1, 1))
    assert not model.runs_local(shifted, dims, 2)


@pytest.mark.parametrize("cp", [2, 4])
def test_local_masks_are_slices_of_the_global_ones(cp):
    """The cached masks of the local dims equal the matching windows of the
    global masks (no temporal shift: the windows of a shard are a contiguous
    run of the (nt, nh, nw) order)."""
    T, H, W = 8, 6, 10
    window, shift = (2, 3, 5), (0, 1, 2)
    glob = swin3d.shifted_window_mask((T, H, W), window, shift)
    local = swin3d.shifted_window_mask((T // cp, H, W), window, shift)
    per_shard = glob.shape[0] // cp
    for r in range(cp):
        np.testing.assert_array_equal(local, glob[r * per_shard:(r + 1) * per_shard])
    G = swin3d.pick_window_group(W // window[2], window[0] * window[1] * window[2])
    gglob = swin3d.grouped_window_mask((T, H, W), window, shift, G)
    glocal = swin3d.grouped_window_mask((T // cp, H, W), window, shift, G)
    np.testing.assert_array_equal(glocal, gglob[:gglob.shape[0] // cp])
