"""The frozen references against the port at tiny sizes on the CPU, both
in float32 from the same weights: they compute the same functions, so a
copy that drifted from the port (or a port that changed under it) shows
here."""

import numpy as np
import pytest
import torch

from common import weights
from drivers.train import as_f32

SEED = 2**31 + 17


def _pair(port_cls, ref_cls, port_cfg, ref_cfg, *args):
    ref = ref_cls(as_f32(ref_cfg), *args)
    port = port_cls(as_f32(port_cfg), *args)
    state = weights.draw(weights.recipe(ref, 0.5), SEED, "cpu")
    ref.load_state_dict(state)
    port.load_state_dict(state)
    return port.eval(), ref.eval()


def test_moge_forward_matches_the_port():
    from labelany3d_tpu_torch.models import moge as pm

    from reference import moge as rm

    port, ref = _pair(pm.MoGeModel, rm.MoGeModel, pm.MoGeConfig.tiny_reference_test(),
                      rm.MoGeConfig.tiny_reference_test(), (64, 64))
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = port(x), ref(x)
    for k in ("points", "mask"):
        torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-5)


def test_depth_pro35_forward_matches_the_port():
    from labelany3d_tpu_torch.models import depth_pro as pd

    from reference import depth_pro as rd

    port, ref = _pair(pd.DepthPro35, rd.DepthPro35, pd.DepthPro35Config.tiny_test(),
                      rd.DepthPro35Config.tiny_test())
    x = torch.rand(1, 512, 512, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        a, b = port(x), ref(x)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-5)


def test_depth_backend_matches_the_port():
    from labelany3d_tpu_torch.models import depth_pro as pd
    from labelany3d_tpu_torch.models import moge as pm
    from labelany3d_tpu_torch.pipeline.backends import TorchDepthBackend

    from reference import depth_backend
    from reference import depth_pro as rd
    from reference import moge as rm

    moge_p, moge_r = _pair(pm.MoGeModel, rm.MoGeModel, pm.MoGeConfig.tiny_reference_test(),
                           rm.MoGeConfig.tiny_reference_test(), (64, 64))
    dp_p, dp_r = _pair(pd.DepthPro35, rd.DepthPro35, pd.DepthPro35Config.tiny_test(),
                       rd.DepthPro35Config.tiny_test())
    backend = TorchDepthBackend(as_f32(pm.MoGeConfig.tiny_reference_test()),
                                as_f32(pd.DepthPro35Config.tiny_test()), device="cpu",
                                use_mesh=False)
    backend.moge, backend.depth_pro = moge_p, dp_p
    imgs = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    a = backend.infer(imgs)
    b = depth_backend.infer(moge_r, dp_r, 512, torch.as_tensor(imgs))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-5)


def test_labelling_program_matches_the_port_with_the_same_draws():
    from labelany3d_tpu_torch.pipeline.labeling import fused_label_program as port_prog

    from reference.labeling import fused_label_program as ref_prog

    g = torch.Generator().manual_seed(4)
    b, h, w = 2, 48, 64
    yy = torch.linspace(2.0, 6.0, h).view(1, h, 1).expand(b, h, w)
    rel = yy * 0.5 + 0.01 * torch.rand(b, h, w, generator=g)
    met = yy + 0.01 * torch.rand(b, h, w, generator=g)
    mask = torch.rand(b, h, w, generator=g) > 0.1
    K = torch.tensor([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]]).expand(b, 3, 3).clone()
    packed = torch.zeros(b, h, w, dtype=torch.int64)
    packed[:, 10:30, 10:30] |= 1
    packed[:, 20:40, 35:60] |= 2
    outs = []
    for prog in (port_prog, ref_prog):
        gen = torch.Generator().manual_seed(5)
        outs.append(prog(rel, met, mask, K, packed, max_instances=4, num_points=64,
                         method="pca", generator=gen))
    torch.testing.assert_close(outs[0][0], outs[1][0])
    for x, y in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(x, y, equal_nan=True)


def test_train_step_matches_the_port():
    from labelany3d_tpu_torch.models import moge as pm
    from labelany3d_tpu_torch.parallel.train import init_train_state, make_train_step

    from gen import depth_scenes
    from reference import moge as rm
    from reference.train import run_steps

    port, ref = _pair(pm.MoGeModel, rm.MoGeModel, pm.MoGeConfig.tiny_reference_test(),
                      rm.MoGeConfig.tiny_reference_test(), (64, 64))
    start = {k: v.clone() for k, v in ref.state_dict().items()}
    params = {"pool": 4, "rects_per_scene": [2, 3], "near_depth": 1.0,
              "far_depths": [4.0, 40.0], "invalid_share": 0.1}
    pool = depth_scenes.make(params, 64, 2, SEED, "cpu")
    batches = [tuple(t[i * 2:(i + 1) * 2] for t in pool) for i in range(2)]
    port.train()
    state, opt = init_train_state(port, learning_rate=1e-3)
    step = make_train_step(port, opt)
    losses = [float(step(state, *b)[1]) for b in batches]
    ref.requires_grad_(True)
    want = run_steps(ref, batches, 1e-3, micro=1)
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    # Adam moves an element whose gradient is round-off (a key's bias) by
    # the sign of that round-off: those are left out, as the cell leaves
    # them out, and each parameter's change compared as a whole.
    from common.checks import moving_masks

    for (name, p), c, m in zip(port.named_parameters(), want["change"],
                               moving_masks(want["grad"])):
        gap = float((p.detach() - start[name] - c)[m].norm())
        assert gap <= 1e-3 * float(c[m].norm()) + 1e-9, name
