"""DINOv2-giant's SwiGLU ViT: the port against the JAX package on the CPU.

  * `ViTConfig.tiny_test(swiglu=True)` (with registers) through both
    packages in float32, the JAX parameters carried by `models/weights.py`
    (its `mlp.w12` and `mlp.w3` Dense layers);
  * `ViTConfig.giant()`'s SwiGLU hidden width (4096 at width 1536) and its
    parameter tree, shape for shape, at full width and depth 2;
  * `convert_dinov2_vit` on a seeded SwiGLU state dict in the torch-hub
    layout (`mlp.w12.*`, `mlp.w3.*`), equal to the JAX converter's tree;
  * `cond_backbone_config("dinov2_vitg14_reg")` equal to the JAX config;
  * the convert CLI's `trellis_cond` entry on a tiny SwiGLU state with a
    `pipeline.json` naming the giant.

Tolerances: converted trees exactly equal (the same numpy operations);
encoder outputs 1e-4 relative, 1e-5 absolute (two float32 blocks, another
summation order), as `tests/test_torch_vit_reference.py`.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from labelany3d_tpu.models import convert as jconvert
from labelany3d_tpu.models import convert_trellis as jconvert_trellis
from labelany3d_tpu.models.vit import ViT as JViT
from labelany3d_tpu.models.vit import ViTConfig as JViTConfig
from labelany3d_tpu_torch.models import convert, convert_cli, convert_trellis
from labelany3d_tpu_torch.models.checkpoints import load_params
from labelany3d_tpu_torch.models.vit import ViT, ViTConfig, swiglu_hidden
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from labelany3d_tpu_torch.utils import safetensors_io
from tests.test_torch_convert_cli import assert_same_tree
from tests.torch_parity import flax_param_shapes, random_flax_params

torch.set_num_threads(1)

MODEL_RTOL = 1e-4
MODEL_ATOL = 1e-5
GRID = (4, 4)


def _tiny(pkg_cfg, dtype, **kw):
    return dataclasses.replace(pkg_cfg.tiny_test(swiglu=True, num_register_tokens=1, **kw),
                               dtype=dtype)


def _released_tiny_state(seed=40, registers=4):
    st = chip_smoke.SyntheticState(seed)
    st.vit("", ViTConfig.tiny_test(swiglu=True, num_register_tokens=registers, pos_grid=GRID),
           n_pos=GRID[0] * GRID[1])
    return dict(st)


def test_swiglu_vit_matches_jax():
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(2, 32, 48, 3)).astype(np.float32)
    jm = JViT(_tiny(JViTConfig, jnp.float32))
    params = random_flax_params(jm.init, jnp.asarray(images), seed=3)
    assert set(params["block0"]["mlp"]) == {"w12", "w3"}
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(images))
    model = ViT(_tiny(ViTConfig, torch.float32), (4, 6))
    model.load_state_dict(flax_to_state_dict(params, model))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    for key in ("tokens", "all_prenorm", "cls"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=MODEL_RTOL,
                                   atol=MODEL_ATOL, err_msg=key)


def test_giant_config_and_parameter_shapes_match_jax():
    assert swiglu_hidden(ViTConfig.giant()) == 4096
    assert (ViTConfig.giant().width, ViTConfig.giant().depth, ViTConfig.giant().num_heads) \
        == (1536, 40, 24)
    jcfg = dataclasses.replace(JViTConfig.giant(num_register_tokens=4, pos_grid=(37, 37)),
                               depth=2, dtype=jnp.float32)
    shapes = flax_param_shapes(JViT(jcfg).init, jnp.zeros((1, 518, 518, 3)))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.shape)
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tcfg = dataclasses.replace(ViTConfig.giant(num_register_tokens=4, pos_grid=(37, 37)),
                               depth=2)
    with torch.device("meta"):
        model = ViT(tcfg, (37, 37))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert want["block0/mlp/w12/kernel"] == (1536, 8192)
    assert got["block0.mlp.w12.weight"] == (8192, 1536)
    assert got["block0.mlp.w3.weight"] == (1536, 4096)
    assert sum(np.prod(s) for s in want.values()) == sum(np.prod(s) for s in got.values())
    assert len(want) == len(got)


def test_convert_swiglu_state_matches_jax():
    state = _released_tiny_state()
    tcfg = ViTConfig.tiny_test(swiglu=True, num_register_tokens=4, pos_grid=GRID)
    jcfg = JViTConfig.tiny_test(swiglu=True, num_register_tokens=4, pos_grid=GRID)
    got = convert.convert_dinov2_vit(state, tcfg, GRID)
    assert_same_tree(got, jconvert.convert_dinov2_vit(state, jcfg, GRID))
    # The converted tree loads into the port's SwiGLU ViT, every key used.
    model = ViT(dataclasses.replace(tcfg, dtype=torch.float32), GRID)
    model.load_state_dict(flax_to_state_dict(got, model))
    np.testing.assert_array_equal(model.block1.mlp.w12.weight.detach().numpy(),
                                  state["blocks.1.mlp.w12.weight"])


def test_cond_backbone_config_giant_matches_jax():
    name = "dinov2_vitg14_reg"
    got, want = convert_trellis.cond_backbone_config(name), \
        jconvert_trellis.cond_backbone_config(name)
    for f in ("patch_size", "width", "depth", "num_heads", "mlp_ratio", "num_register_tokens",
              "use_class_token", "layerscale_init", "swiglu", "pos_embed", "pos_grid"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.swiglu and got.width == 1536 and got.num_register_tokens == 4


def test_cli_trellis_cond_converts_a_tiny_giant(tmp_path):
    state = _released_tiny_state(seed=41, registers=0)  # the CLI's tiny ViT has none
    ckpt = tmp_path / "cond.safetensors"
    safetensors_io.save_file(state, str(ckpt))
    pipeline = tmp_path / "pipeline.json"
    pipeline.write_text(json.dumps({"image_cond_model": "dinov2_vitg14_reg"}))
    store = tmp_path / "store"
    convert_cli.main(["trellis_cond", str(ckpt), "--out", str(store), "--tiny",
                      "--config", str(pipeline)])
    jcfg = JViTConfig.tiny_test(swiglu=True, pos_grid=GRID)
    assert_same_tree(load_params(str(store), "trellis_cond"),
                     jconvert_trellis.convert_trellis_cond(state, jcfg))
