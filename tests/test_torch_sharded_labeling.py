"""The labeling step data-parallel over 2 gloo ranks on the CPU: each rank
runs `labeling_step` on its rows, with its rows of the whole batch's
draws, and the rows put back together equal the one-process step on the
same draws (aligned depth and box centres 1e-5 absolute and relative,
valid counts exactly). The counterpart of `tests/test_sharded_labeling.py`;
the ranks run through `parallel.launch.run_ranks`."""

import numpy as np
import torch

from labelany3d_tpu_torch.parallel.dryrun import labeling_batch, labeling_worker
from labelany3d_tpu_torch.parallel.launch import run_ranks
from labelany3d_tpu_torch.pipeline.labeling import labeling_step


def test_labeling_step_over_data_ranks_matches_one_process():
    inputs, draws = labeling_batch(b=8)
    aligned, out = labeling_step(*(torch.as_tensor(a) for a in inputs), draws=draws,
                                 num_points=64)
    ranks = run_ranks(labeling_worker, 2, device="cpu", args=(inputs, draws, 64),
                      timeout=120.0)
    assert [r["aligned"].shape[0] for r in ranks] == [4, 4]
    np.testing.assert_allclose(np.concatenate([r["aligned"] for r in ranks]),
                               aligned.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["center_cam"] for r in ranks]),
                               out.boxes.center_cam.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.concatenate([r["num_valid"] for r in ranks]),
                                  out.num_valid.numpy())
    assert out.num_valid.numpy().sum() > 0
