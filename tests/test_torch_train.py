"""The fine-tuning step (`parallel/train.py`) and K1's gradient: the port
against the JAX package on the CPU, in float32.

  * K1's d`qkv` (`ops.attention.packed_sdpa_backward` under autograd)
    against `jax.grad` of `packed_flash_sdpa` (its custom VJP over
    `_packed_reference`), with n_real < Npad and a cotangent on every row:
    1e-5 absolute. NaN pad rows with a zero cotangent there (the model's
    case) leave every gradient finite and the real rows' equal to those of
    finite pads (exactly).
  * `depth_loss` with masked pixels: 1e-6 relative.
  * The train step against JAX's `init_train_state` / `make_train_step`
    without a mesh, on `MoGeConfig.tiny_test()` and
    `tiny_reference_test()` at float32 from the same parameters
    (`flax_to_state_dict`, which also carries JAX's gradient tree): the
    loss at each of 3 steps to 1e-5 relative, step 1's gradients to 1e-4
    relative L2 per tensor, and each parameter's change over the 3 steps
    to 2e-3 relative L2 per tensor (measured at most 3.5e-4). The key
    bias is left out of that last check: its gradient is zero in exact
    arithmetic, and optax's updates, which normalise the gradient, move it
    by up to the learning rate on rounding noise alone. With torch's
    default weight_decay of 0.01 planted, the parameter comparison fails
    (measured 1.1e-2 at the norm scales).
  * A bf16 tiny run's loss falls over 5 steps (`tests/test_parallel.py`'s
    check of the JAX step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models import moge as jmoge
from labelany3d_tpu.models.vit import ViTConfig as JViTConfig
from labelany3d_tpu.ops.attention import packed_flash_sdpa
from labelany3d_tpu.parallel import train as jtrain
from labelany3d_tpu_torch.models import moge
from labelany3d_tpu_torch.models.vit import ViTConfig
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from labelany3d_tpu_torch.ops import attention as att
from labelany3d_tpu_torch.parallel import train
from tests.torch_parity import random_flax_params

HW = (32, 32)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
DELTA_REL = 2e-3


def f32_configs(kind: str):
    """(JAX, port) MoGe configs of `kind` ('tiny' or 'reference') with every
    dtype float32."""
    if kind == "tiny":
        j = dataclasses.replace(
            jmoge.MoGeConfig.tiny_test(), dtype=jnp.float32,
            backbone=dataclasses.replace(JViTConfig.tiny_test(out_indices=(0, 1)),
                                         dtype=jnp.float32))
        t = dataclasses.replace(
            moge.MoGeConfig.tiny_test(), dtype=torch.float32,
            backbone=dataclasses.replace(ViTConfig.tiny_test(out_indices=(0, 1)),
                                         dtype=torch.float32))
        return j, t
    j, t = jmoge.MoGeConfig.tiny_reference_test(), moge.MoGeConfig.tiny_reference_test()
    return (dataclasses.replace(j, backbone=dataclasses.replace(j.backbone, dtype=jnp.float32)),
            dataclasses.replace(t, backbone=dataclasses.replace(t.backbone,
                                                                dtype=torch.float32)))


def train_batch(b: int = 4, hw=HW, seed: int = 0):
    """Seeded images, target depths in [1, 4] and valid masks whose valid
    share differs by image (0.9, 0.5, 0.7, 0.2)."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, *hw, 3)).astype(np.float32)
    target = rng.uniform(1.0, 4.0, size=(b, *hw)).astype(np.float32)
    frac = np.array([0.9, 0.5, 0.7, 0.2] * (b // 4 + 1))[:b, None, None]
    return images, target, rng.uniform(size=(b, *hw)) < frac


class SeededInit:
    """A Flax model whose `init` fills the parameter tree's shapes from a
    numpy seed (`random_flax_params`): `init_train_state` calls only
    `init`, and Flax's own init of these models takes about 20 s unjitted."""

    def __init__(self, model):
        self.init = lambda rng, x: {"params": random_flax_params(model.init, x, seed=3)}


def jax_run(jcfg, batch, steps: int = 3):
    """JAX's init_train_state / make_train_step without a mesh: the initial
    parameters, step 1's gradients, the losses and the parameters after
    `steps` steps (numpy trees)."""
    model = jmoge.MoGeModel(jcfg)
    images, target, valid = batch
    state, tx = jtrain.init_train_state(SeededInit(model), jax.random.PRNGKey(0),
                                        jnp.zeros((1, *images.shape[1:3], 3)))
    params0 = jax.tree.map(np.asarray, state.params)

    def loss_fn(p):
        return jtrain.depth_loss(model.apply({"params": p}, images)["points"][..., 2],
                                 target, valid)

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(state.params))
    step = jtrain.make_train_step(model, tx)
    losses = []
    for _ in range(steps):
        state, loss = step(state, images, target, valid)
        losses.append(float(loss))
    return params0, grads, losses, jax.tree.map(np.asarray, state.params)


def torch_run(tcfg, params0, batch, steps: int = 3, weight_decay: float | None = None):
    """The port's step without a mesh from `params0`: the model, the
    losses and step 1's gradients. `weight_decay` replaces the optimizer's
    (a planted fault)."""
    model = moge.MoGeModel(tcfg, batch[0].shape[1:3])
    state, opt = train.init_train_state(model, params=params0)
    if weight_decay is not None:
        opt.param_groups[0]["weight_decay"] = weight_decay
    step = train.make_train_step(model, opt)
    x = [torch.from_numpy(a) for a in batch]
    losses, grads = [], None
    for i in range(steps):
        state, loss = step(state, *x)
        losses.append(float(loss))
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    assert state.step == steps
    return model, losses, grads


def rel(a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def test_k1_gradient_matches_jax_grad():
    rng = np.random.default_rng(0)
    b, n_pad, n_real, heads, d = 2, 64, 50, 2, 16
    qkv = rng.normal(size=(b, n_pad, 3 * heads * d)).astype(np.float32)
    cot = rng.normal(size=(b, n_pad, heads * d)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(packed_flash_sdpa(t, heads, n_real) * cot))(
        jnp.asarray(qkv))
    t = torch.from_numpy(qkv).requires_grad_()
    calls = att.BACKWARD_CALLS.count
    out = att.packed_sdpa(t, heads, n_real)
    assert out.grad_fn is not None
    (out * torch.from_numpy(cot)).sum().backward()
    assert att.BACKWARD_CALLS.count == calls + 1
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-5)


def test_k1_gradient_ignores_nan_pad_rows():
    rng = np.random.default_rng(1)
    b, n_pad, n_real, heads, d = 2, 64, 37, 2, 16
    qkv = rng.normal(size=(b, n_pad, 3 * heads * d)).astype(np.float32)
    cot = rng.normal(size=(b, n_pad, heads * d)).astype(np.float32)
    cot[:, n_real:] = 0.0  # pad rows feed nothing downstream
    grads = []
    for fill in (0.0, np.nan):
        x = qkv.copy()
        x[:, n_real:] = fill
        t = torch.from_numpy(x).requires_grad_()
        (att.packed_sdpa(t, heads, n_real) * torch.from_numpy(cot)).sum().backward()
        grads.append(t.grad)
    assert torch.isfinite(grads[1]).all()
    assert torch.equal(grads[0], grads[1])
    assert not grads[1][:, n_real:].any()


def test_depth_loss_matches_jax():
    rng = np.random.default_rng(2)
    pred = rng.uniform(0.0, 5.0, size=(3, 16, 16)).astype(np.float32)
    pred[0, :2] = 0.0  # clamped at 1e-6 on both sides
    target = rng.uniform(0.5, 5.0, size=(3, 16, 16)).astype(np.float32)
    valid = rng.uniform(size=(3, 16, 16)) < 0.6
    want = float(jtrain.depth_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(valid)))
    got = float(train.depth_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                 torch.from_numpy(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.fixture(scope="module", params=["tiny", "reference"])
def runs(request):
    jcfg, tcfg = f32_configs(request.param)
    batch = train_batch()
    return tcfg, batch, jax_run(jcfg, batch)


def change_error(got: dict, start: dict, want: dict) -> tuple[float, str]:
    """The largest relative L2, over parameter tensors (state dicts of
    tensors), of the change `got - start` against `want - start`. The key
    bias (the middle third of each `qkv.bias`) is left out on both sides:
    it adds a constant to each score row, so its gradient is zero in exact
    arithmetic, and Adam turns its rounding noise into steps of up to the
    learning rate."""
    worst = (0.0, "")
    for k, p in got.items():
        a, b = p.detach() - start[k], want[k] - start[k]
        if k.endswith("attn.qkv.bias"):
            w = b.shape[0] // 3
            keep = torch.ones_like(b, dtype=torch.bool)
            keep[w:2 * w] = False
            a, b = a[keep], b[keep]
        worst = max(worst, (rel(a, b), k))
    return worst


def jax_change_error(model, params0, jax_params) -> tuple[float, str]:
    """`change_error` of `model`'s parameters against JAX's trees."""
    return change_error(dict(model.named_parameters()), flax_to_state_dict(params0, model),
                        flax_to_state_dict(jax_params, model))


def test_train_step_matches_jax(runs):
    tcfg, batch, (params0, jgrads, jlosses, jparams) = runs
    model, losses, grads = torch_run(tcfg, params0, batch)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    want = flax_to_state_dict(jgrads, model)
    assert set(grads) == set(want)
    worst = max((rel(g, want[k]), k) for k, g in grads.items())
    assert worst[0] <= GRAD_REL, worst
    worst = jax_change_error(model, params0, jparams)
    assert worst[0] <= DELTA_REL, worst


def test_planted_torch_weight_decay_fails(runs):
    """torch.optim.AdamW's default decay (0.01, against optax's 1e-4)."""
    tcfg, batch, (params0, _, jlosses, jparams) = runs
    model, losses, _ = torch_run(tcfg, params0, batch, weight_decay=0.01)
    assert jax_change_error(model, params0, jparams)[0] > DELTA_REL


def test_bf16_tiny_run_learns():
    model = moge.MoGeModel(moge.MoGeConfig.tiny_test(), HW)
    state, opt = train.init_train_state(model, torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in model.parameters())  # f32 master weights
    step = train.make_train_step(model, opt)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(size=(8, *HW, 3)).astype(np.float32))
    target = torch.full((8, *HW), 3.0)
    valid = torch.ones((8, *HW), dtype=torch.bool)
    losses = []
    for _ in range(5):
        state, loss = step(state, images, target, valid)
        losses.append(float(loss))
    assert state.step == 5 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_train_step_spans_under_a_profiler():
    """Three steps give, each in order, `train.step` around `train.forward`,
    `train.backward` and `train.optimizer`, with the step as their unit;
    without a profiler they give none."""
    from labelany3d_tpu_torch.utils import profiling

    model = moge.MoGeModel(moge.MoGeConfig.tiny_test(), HW)
    state, opt = train.init_train_state(model, torch.Generator().manual_seed(0))
    step = train.make_train_step(model, opt)
    images, target, valid = (torch.from_numpy(np.asarray(a)) for a in train_batch())
    profiling.clear_spans()
    state, _ = step(state, images, target, valid)
    assert profiling.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            state, _ = step(state, images, target, valid)
    spans = profiling.spans()
    names = ["train.step", "train.forward", "train.backward", "train.optimizer"]
    assert [s.name for s in spans] == names * 3
    for k in range(3):
        top, *phases = spans[4 * k:4 * k + 4]
        assert top.parent is None and all(s.parent == 4 * k for s in phases)
        assert {s.unit for s in spans[4 * k:4 * k + 4]} == {1 + k}
        assert top.start <= phases[0].start and phases[-1].end <= top.end
        assert all(a.end <= b.start for a, b in zip(phases, phases[1:]))
    assert state.step == 4
    profiling.clear_spans()
    step(state, images, target, valid)
    assert profiling.spans() == []
