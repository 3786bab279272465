"""`labelany3d_tpu_torch/parallel/`: meshes, the Megatron layout, the dp x tp
step over gloo ranks on the CPU, and the dry run, against the JAX package
(on the conftest's 8 virtual CPU devices) and against the port's own
one-process step.

Tolerances (float32): the dp=2 x tp=2 forward against JAX's one-device
forward 1e-5 absolute (the row-parallel sums reduce in another order); the
dp=2 x tp=2 step (batch 4 with valid shares 0.9, 0.5 | 0.7, 0.2, so the
two data ranks hold unequal valid counts) against the one-process port and
against JAX: losses 1e-5 relative at each of 3 steps, each parameter's
change 2e-3 relative L2 (`tests/test_torch_train.py::change_error`). Shard
layouts, specs and shapes are compared exactly; the depth backend's row
split over ("cpu", "cpu") equals one device's output exactly.

Every multi-rank test runs through `parallel.launch.run_ranks`, with a
deadline of its own.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models import moge as jmoge
from labelany3d_tpu.models.vit import ViT as JViT
from labelany3d_tpu.models.vit import ViTConfig as JViTConfig
from labelany3d_tpu.parallel import make_mesh as jmake_mesh
from labelany3d_tpu.parallel import param_pspecs as jparam_pspecs
from labelany3d_tpu_torch.models import moge
from labelany3d_tpu_torch.models.vit import ViT, ViTConfig
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from labelany3d_tpu_torch.ops.attention import packed_sdpa
from labelany3d_tpu_torch.parallel import mesh_shape, param_pspecs
from labelany3d_tpu_torch.parallel.dryrun import dryrun_multichip, train_worker
from labelany3d_tpu_torch.parallel.launch import run_ranks
from labelany3d_tpu_torch.parallel.sharding import (
    shard_shape,
    shard_tensor,
    unshard_tensor,
)
from tests.test_torch_train import (
    DELTA_REL,
    LOSS_RTOL,
    change_error,
    f32_configs,
    jax_change_error,
    jax_run,
    torch_run,
    train_batch,
)

RANK_DEADLINE_S = 120.0


@pytest.mark.parametrize("data,model", [(4, 2), (-1, 2), (8, 1), (-1, 1), (2, 2), (-1, 4),
                                        (1, 1)])
def test_mesh_shape_matches_jax(data, model):
    mesh = jmake_mesh(data=data, model=model)
    assert mesh_shape(8, data, model) == (mesh.shape["data"], mesh.shape["model"])


@pytest.mark.parametrize("data,model", [(-1, 3), (3, 3), (1, 0), (9, 1)])
def test_mesh_shape_errors_match_jax(data, model):
    with pytest.raises(ValueError) as want:
        jmake_mesh(data=data, model=model)
    with pytest.raises(ValueError) as got:
        mesh_shape(8, data, model)
    assert str(got.value) == str(want.value)


def _torch_spec(path: tuple, spec) -> tuple[str, tuple]:
    """A JAX parameter path and spec in the port's names and layout: 2D
    Dense kernels are transposed, so their spec is reversed."""
    *mods, leaf = path
    spec = tuple(spec)
    if leaf == "kernel" and len(spec) == 2:
        spec = spec[::-1]
    return ".".join([*mods, {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)]), spec


def _jax_specs(params) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        jparam_pspecs(params), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return dict(_torch_spec(tuple(getattr(k, "key", str(k)) for k in path), s)
                for path, s in flat)


@pytest.mark.parametrize("swiglu", [False, True])
def test_param_specs_match_jax(swiglu):
    jcfg = JViTConfig.tiny_test(out_indices=(0, 1), swiglu=swiglu)
    shapes = jax.eval_shape(JViT(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    model = ViT(ViTConfig.tiny_test(out_indices=(0, 1), swiglu=swiglu), (4, 4))
    want = _jax_specs(shapes)
    got = param_pspecs(model)
    assert set(got) == set(want)
    assert got == {k: tuple(s for s in want[k]) for k in got}
    assert got["block0.attn.qkv.weight"] == ("model", None)
    assert got["block0.attn.proj.bias"] == ()


def test_production_shard_shapes_match_jax():
    """MoGe ViT-L at 518 px: each parameter's shard at tp = 2, the port's
    rule on its `meta` shapes against JAX `param_pspecs` of `jax.eval_shape`
    (a Dense kernel's sharded dim is the other dim of the transposed torch
    weight)."""
    shapes = jax.eval_shape(jmoge.MoGeModel(jmoge.MoGeConfig.vitl()).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 518, 518, 3)))["params"]
    specs = _jax_specs(shapes)
    with torch.device("meta"):
        model = moge.MoGeModel(moge.MoGeConfig.vitl(), (518, 518))
    full = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert set(full) == set(specs)
    for name, shape in full.items():
        spec = specs[name] + (None,) * (len(shape) - len(specs[name]))
        want = tuple(n // 2 if a == "model" else n for n, a in zip(shape, spec))
        assert shard_shape(name, shape, 2) == want, name
    sharded = [k for k, s in specs.items() if "model" in s]
    assert len(sharded) == 24 * 6  # qkv weight and bias, proj, fc1 weight and bias, fc2
    assert shard_shape("backbone.block3.attn.qkv.weight", full[
        "backbone.block3.attn.qkv.weight"], 2) == (1536, 1024)
    assert shard_shape("backbone.block3.mlp.fc1.weight", full[
        "backbone.block3.mlp.fc1.weight"], 2) == (2048, 1024)


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_follow_heads(tp):
    """Each rank's qkv shard holds its heads' q, k and v (K1 on H/tp heads
    gives those heads' columns of the full attention), w12's halves stay
    paired, and the gathered shards are the full weights."""
    torch.manual_seed(0)
    w, heads, d, n = 64, 4, 16, 32
    qkv_w, qkv_b = torch.randn(3 * w, w), torch.randn(3 * w)
    x = torch.randn(2, n, w)
    full = packed_sdpa(torch.nn.functional.linear(x, qkv_w, qkv_b), heads, 29)
    hid = 48
    w12 = torch.randn(2 * hid, w)
    x1, x2 = torch.nn.functional.linear(x, w12).chunk(2, dim=-1)
    full_glu = torch.nn.functional.silu(x1) * x2
    for name, t in (("b.attn.qkv.weight", qkv_w), ("b.attn.qkv.bias", qkv_b),
                    ("b.mlp.w12.weight", w12), ("b.attn.proj.weight", torch.randn(w, w)),
                    ("b.mlp.fc2.weight", torch.randn(w, 4 * w))):
        shards = [shard_tensor(name, t, r, tp) for r in range(tp)]
        assert all(s.shape == shard_shape(name, t.shape, tp) for s in shards)
        assert torch.equal(unshard_tensor(name, shards), t)
    for r in range(tp):
        local = torch.nn.functional.linear(x, shard_tensor("b.attn.qkv.weight", qkv_w, r, tp),
                                           shard_tensor("b.attn.qkv.bias", qkv_b, r, tp))
        cols = slice(r * w // tp, (r + 1) * w // tp)
        torch.testing.assert_close(packed_sdpa(local, heads // tp, 29), full[..., cols])
        y1, y2 = torch.nn.functional.linear(
            x, shard_tensor("b.mlp.w12.weight", w12, r, tp)).chunk(2, dim=-1)
        torch.testing.assert_close(torch.nn.functional.silu(y1) * y2,
                                   full_glu[..., r * hid // tp:(r + 1) * hid // tp])


@pytest.fixture(scope="module")
def dp_tp_runs():
    """The tiny f32 MoGe from seeded parameters: JAX's one-device forward
    and 3 steps, the port's one-process 3 steps, and the port's dp=2 x
    tp=2 run over 4 gloo ranks (forward rows, then 3 steps)."""
    jcfg, tcfg = f32_configs("tiny")
    batch = train_batch(4)
    params0, _, jlosses, jparams = jax_run(jcfg, batch)
    jm = jmoge.MoGeModel(jcfg)
    jpoints = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x)["points"])(
        params0, batch[0]))
    model, losses, _ = torch_run(tcfg, params0, batch)
    ranks = run_ranks(train_worker, 4, device="cpu",
                      args=(tcfg, batch[0].shape[1:3], 2, 2, batch, 3, params0),
                      timeout=RANK_DEADLINE_S)
    return dict(params0=params0, jpoints=jpoints, jlosses=jlosses, jparams=jparams,
                model=model, losses=losses, ranks=ranks)


def test_dp_tp_forward_matches_jax(dp_tp_runs):
    ranks = dp_tp_runs["ranks"]
    assert [r["coordinate"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert not any(r["forbidden"] for r in ranks)  # the children imported no JAX
    rows = np.concatenate([r["points"] for r in ranks if r["coordinate"][1] == 0])
    np.testing.assert_allclose(rows, dp_tp_runs["jpoints"], atol=1e-5)
    # The model ranks of a data group compute the same rows.
    np.testing.assert_array_equal(ranks[0]["points"], ranks[1]["points"])


def test_dp_tp_step_matches_one_process_and_jax(dp_tp_runs):
    ranks, model = dp_tp_runs["ranks"], dp_tp_runs["model"]
    batch = train_batch(4)
    counts = batch[2].reshape(4, -1).sum(-1)
    assert counts[:2].sum() != counts[2:].sum()  # unequal valid counts per data rank
    for r in ranks:
        assert r["step"] == 3
        np.testing.assert_allclose(r["losses"], dp_tp_runs["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["losses"], dp_tp_runs["jlosses"], rtol=LOSS_RTOL)
    got = {k: torch.from_numpy(v) for k, v in ranks[0]["params"].items()}
    start = flax_to_state_dict(dp_tp_runs["params0"], model)
    one = {k: p.detach() for k, p in model.named_parameters()}
    assert change_error(got, start, one)[0] <= DELTA_REL
    assert change_error(got, start, flax_to_state_dict(dp_tp_runs["jparams"], model))[0] \
        <= DELTA_REL
    assert jax_change_error(model, dp_tp_runs["params0"], dp_tp_runs["jparams"])[0] <= DELTA_REL


def test_dryrun_multichip_on_cpu_ranks():
    reports = dryrun_multichip(4, device="cpu", timeout=RANK_DEADLINE_S)
    assert [r["coordinate"] for r in reports] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in reports:
        assert r["step"] == 2 and np.isfinite(r["losses"]).all() and not r["forbidden"]
        assert r["production_shards"]["qkv_out"] == 1536
        assert r["production_shards"]["fc1_out"] == 2048
        assert r["production_shards"]["local_heads"] == 8
        assert r["production_split"]["matcher_views"] == 4
        assert r["labeling_rows"] == 2


def test_run_ranks_raises_for_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank"):
        run_ranks(train_worker, 2, device="cpu", args=(None, (32, 32), 2, 1, (), 1),
                  timeout=RANK_DEADLINE_S)


def test_depth_backend_splits_rows_over_devices():
    """`devices=("cpu", "cpu")`: two replicas, two rows each, the same
    outputs as one device's batch of 4 (the JAX backend's `use_mesh`)."""
    from labelany3d_tpu_torch.pipeline.backends import make_depth

    images = np.random.default_rng(0).integers(0, 255, (4, 64, 64, 3), dtype=np.uint8)
    one = make_depth("tiny_test", device="cpu")
    two = make_depth("tiny_test", devices=("cpu", "cpu"))
    assert len(two.devices) == 2 and len(one.devices) == 1
    want, got = one.infer(images), two.infer(images)
    assert len(two._replicas) == 1
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert make_depth("tiny_test", device="cpu", use_mesh=True).devices == [torch.device("cpu")]
