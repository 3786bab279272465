"""Training the two-view matcher (`MatcherConfig.tiny_catmlpdpt_test`, the
MASt3R layout at a tiny size) on the CPU in float32, against the
benchmark's plain reference (`portbench/reference/matcher.py`,
`reference/train_pairs.py`) from the same seeded weights
(`portbench/common/weights.py`):

  * the port's `TwoViewMatcher` forward, each of its eight outputs, in
    inference (the decoder stream by stream) and under autograd (both
    streams batched);
  * the pair objective (`parallel/pair_loss.py`) on the loss and on every
    parameter's gradient;
  * three `make_train_step` steps with that objective against the
    reference's AdamW steps, parameter by parameter, with torch's foreach
    and fused AdamW;
  * the pair generator's correspondences (`portbench/gen/view_pairs.py`).

Tolerances: 1e-4 relative (atol 1e-5) on the forward's outputs and the
loss, as the matcher's parity tests; the gradients 1e-4 of each
parameter's gradient norm (the port sums the loss over all pixels with
masks as weights, the reference over boolean selections, so the order of
the sums differs); each parameter's change 1e-3 of its norm over the
elements that Adam moves by more than round-off, as the MoGe step's test.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

PORTBENCH = Path(__file__).resolve().parents[1] / "portbench"
if str(PORTBENCH) not in sys.path:
    sys.path.insert(0, str(PORTBENCH))

from common import weights  # noqa: E402
from common.checks import moving_masks  # noqa: E402
from gen import view_pairs  # noqa: E402
from reference import matcher as rm  # noqa: E402
from reference.train_pairs import loss_and_grads, run_steps  # noqa: E402

from labelany3d_tpu_torch.models import matcher as pm  # noqa: E402
from labelany3d_tpu_torch.parallel.pair_loss import pair_objective  # noqa: E402
from labelany3d_tpu_torch.parallel.train import init_train_state, make_train_step  # noqa: E402

SEED = 2**31 + 21
SIZE = 64
MATCHES = 32
KEYS = ("pts3d0", "conf0", "desc0", "desc_conf0", "pts3d1", "conf1", "desc1", "desc_conf1")
TRAFFIC = {"pool": 6, "rects_per_scene": [2, 5, 8], "near_depth": 1.0, "far_depth": 40.0,
           "centre_depths": [4.0, 12.0], "rotation_deg": [10.0, 45.0], "max_yaw_deg": 40.0,
           "focal_share": 0.9, "invalid_share": 0.1, "depth_tol": 0.02}


def _f32(cfg):
    return dataclasses.replace(cfg, dtype=torch.float32,
                               encoder=dataclasses.replace(cfg.encoder, dtype=torch.float32))


def _models():
    grid = (SIZE // 16, SIZE // 16)
    ref = rm.TwoViewMatcher(_f32(rm.MatcherConfig.tiny_catmlpdpt_test()), grid)
    port = pm.TwoViewMatcher(_f32(pm.MatcherConfig.tiny_catmlpdpt_test()), grid)
    state = weights.draw(weights.recipe(ref, 1.0), SEED, "cpu")
    ref.load_state_dict(state)
    port.load_state_dict(state)
    return port, ref


@pytest.fixture(scope="module")
def pool():
    return view_pairs.make(TRAFFIC, SIZE, 2, MATCHES, SEED + 1, "cpu", cameras=True)


@pytest.fixture(scope="module")
def forwards(pool):
    port, ref = _models()
    with torch.no_grad():
        return port(pool[0][:3], pool[1][:3]), ref(pool[0][:3], pool[1][:3])


@pytest.mark.parametrize("key", KEYS)
def test_matcher_output_matches_the_reference(forwards, key):
    got, want = forwards
    assert set(got) == set(want) == set(KEYS)
    torch.testing.assert_close(got[key], want[key], rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def forwards_under_autograd(pool):
    port, ref = _models()
    got = port(pool[0][:3], pool[1][:3])
    with torch.no_grad():
        return {k: v.detach() for k, v in got.items()}, ref(pool[0][:3], pool[1][:3])


@pytest.mark.parametrize("key", KEYS)
def test_matcher_output_under_autograd_matches_the_reference(forwards_under_autograd, key):
    """Under autograd the decoder runs its two streams batched
    (`cross_blocks`); the outputs are the per-stream reference's."""
    got, want = forwards_under_autograd
    torch.testing.assert_close(got[key], want[key], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pairs", [1, 3])
def test_pair_objective_matches_the_reference(pool, pairs):
    port, ref = _models()
    batch = tuple(t[:pairs] for t in pool[:8])
    loss = pair_objective(port, *batch)
    loss.backward()
    want_loss, want_grads = loss_and_grads(ref.requires_grad_(True), batch, micro=1)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-4)
    for (name, p), g in zip(port.named_parameters(), want_grads):
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        assert float((got - g).norm()) <= 1e-4 * float(g.norm()) + 1e-9, name


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("micro", [1, 2])
def test_train_steps_match_the_reference(pool, micro, fused):
    port, ref = _models()
    start = {k: v.detach().clone() for k, v in port.state_dict().items()}
    batches = [tuple(t[2 * i:2 * i + 2] for t in pool[:8]) for i in range(3)]
    state, opt = init_train_state(port, learning_rate=1e-3, fused=fused)
    step = make_train_step(port, opt, objective=pair_objective)
    losses = [float(step(state, *b)[1]) for b in batches]
    want = run_steps(ref.requires_grad_(True), batches, 1e-3, micro)
    assert losses == pytest.approx(want["losses"], rel=1e-4)
    for (name, p), c, m in zip(port.named_parameters(), want["change"],
                               moving_masks(want["grad"])):
        gap = float((p.detach() - start[name] - c)[m].norm())
        assert gap <= 1e-3 * float(c[m].norm()) + 1e-9, name


@pytest.mark.parametrize("pair", range(TRAFFIC["pool"]))
def test_generator_correspondences_pass_the_depth_test(pool, pair):
    _, _, pts0, pts1, valid0, valid1, corr0, corr1, rot1, origin1 = (t[pair] for t in pool)
    assert corr0.shape == corr1.shape == (MATCHES,)
    assert len(set(corr0.tolist())) == len(set(corr1.tolist())) == MATCHES
    assert valid0.reshape(-1)[corr0].all() and valid1.reshape(-1)[corr1].all()
    z0 = ((pts0.reshape(-1, 3)[corr0] - origin1) @ rot1)[:, 2]
    z1 = ((pts1.reshape(-1, 3)[corr1] - origin1) @ rot1)[:, 2]
    assert ((z1 - z0).abs() <= TRAFFIC["depth_tol"] * z0).all()


@pytest.mark.parametrize("data", [2, 4])
def test_pair_objective_refuses_a_data_axis(pool, data):
    """The pair objective's mean over a rank's pairs cannot be summed over
    ranks, so a step with it refuses a mesh whose data axis is over 1
    before running the model."""
    port, _ = _models()
    state, opt = init_train_state(port)
    state.mesh = type("Mesh", (), {"size": lambda self, axis: data})()
    step = make_train_step(port, opt, objective=pair_objective)
    with pytest.raises(ValueError, match="data axis"):
        step(state, *(t[:2] for t in pool[:8]))
    assert state.step == 0
