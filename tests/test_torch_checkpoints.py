"""The port's weight store (`models/checkpoints.py`) and its `.safetensors`
codec (`utils/safetensors_io.py`).

  * The codec against the `safetensors` package, both ways, for every dtype
    it takes (F32, F16, BF16, I32, I64, BOOL): exact.
  * The store round-trips a converted tree exactly (values, dtypes, keys);
    a missing name gives None; `like=` mismatches raise; an orbax store
    written by the JAX package's `save_params` raises `ValueError` (never
    None, which would mean random weights in silence).
  * `convert_and_save_dinov2` stores what the JAX function converts.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from labelany3d_tpu_torch.models import checkpoints
from labelany3d_tpu_torch.utils import safetensors_io


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"f32": torch.randn(3, 5, generator=g),
            "f16": torch.randn(7, generator=g).half(),
            "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
            "i32": torch.arange(-3, 5, dtype=torch.int32).reshape(2, 4),
            "i64": torch.arange(3, dtype=torch.int64) * (1 << 40),
            "bool": torch.tensor([[True, False, True]]),
            "scalar": torch.tensor(2.5),
            "empty": torch.zeros(0, 4)}


def _assert_same(got: dict, want: dict):
    assert list(got) == list(want) or set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert torch.equal(got[k], want[k]), k


def test_codec_reads_what_the_package_writes(tmp_path):
    from safetensors.torch import save_file

    want = _tensors()
    save_file(want, str(tmp_path / "pkg.safetensors"), metadata={"format": "pt"})
    _assert_same(safetensors_io.load_file(str(tmp_path / "pkg.safetensors")), want)


def test_package_reads_what_the_codec_writes(tmp_path):
    from safetensors.torch import load_file

    want = _tensors()
    # numpy leaves are written too (bf16 has no numpy dtype).
    mixed = {k: (v.numpy() if v.dtype != torch.bfloat16 else v) for k, v in want.items()}
    safetensors_io.save_file(mixed, str(tmp_path / "ours.safetensors"), metadata={"a": 1})
    _assert_same(load_file(str(tmp_path / "ours.safetensors")), want)
    header, start = safetensors_io.read_header(str(tmp_path / "ours.safetensors"))
    assert start % 8 == 0 and set(header) == set(want)


def _tree():
    rng = np.random.default_rng(1)
    return {"block0": {"attn": {"qkv": {"kernel": rng.standard_normal((4, 12), np.float32),
                                        "bias": np.zeros(12, np.float32)}},
                       "norm": {"scale": rng.standard_normal(4).astype(np.float16)}},
            "pos_embed": rng.standard_normal((1, 2, 2, 4)).astype(np.float32),
            "steps": np.arange(3, dtype=np.int32),
            "ramping_coefficients": np.float32(0.5) * np.ones(7, np.float32)}


def _assert_same_tree(got, want):
    assert isinstance(got, dict) and set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_same_tree(got[k], w)
        else:
            w = np.asarray(w)
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w)


def test_store_round_trips_exactly(tmp_path):
    tree = _tree()
    path = checkpoints.save_params(str(tmp_path), "trellis_cond", tree)
    assert path == str(tmp_path / "trellis_cond")
    assert (tmp_path / "trellis_cond" / checkpoints.PARAMS_FILE).is_file()
    _assert_same_tree(checkpoints.load_params(str(tmp_path), "trellis_cond"), tree)
    _assert_same_tree(checkpoints.load_params(str(tmp_path), "trellis_cond", like=tree), tree)
    # Saving again replaces the tree.
    checkpoints.save_params(str(tmp_path), "trellis_cond", {"a": np.ones(2, np.float32)})
    assert set(checkpoints.load_params(str(tmp_path), "trellis_cond")) == {"a"}


def test_store_keeps_bfloat16_leaves(tmp_path):
    t = torch.randn(3, 2, generator=torch.Generator().manual_seed(2)).bfloat16()
    checkpoints.save_params(str(tmp_path), "x", {"w": t})
    got = checkpoints.load_params(str(tmp_path), "x")["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, t)


def test_missing_name_gives_none(tmp_path):
    assert checkpoints.load_params(str(tmp_path), "nope") is None
    assert checkpoints.load_params(str(tmp_path / "no_dir"), "svrm") is None


@pytest.mark.parametrize("change", ["missing", "extra", "shape", "dtype"])
def test_like_mismatch_raises(tmp_path, change):
    tree = _tree()
    checkpoints.save_params(str(tmp_path), "m", tree)
    like = _tree()
    if change == "missing":
        like["block0"]["attn"]["qkv"]["other"] = np.zeros(1, np.float32)
    elif change == "extra":
        del like["steps"]
    elif change == "shape":
        like["pos_embed"] = like["pos_embed"][:, :1]
    else:
        like["block0"]["norm"]["scale"] = like["block0"]["norm"]["scale"].astype(np.float32)
    with pytest.raises(ValueError):
        checkpoints.load_params(str(tmp_path), "m", like=like)


def test_orbax_store_of_the_jax_package_raises(tmp_path):
    from labelany3d_tpu.models.checkpoints import save_params as jax_save_params

    jax_save_params(str(tmp_path), "svrm", {"w": np.ones((2, 2), np.float32)})
    assert not (tmp_path / "svrm" / checkpoints.PARAMS_FILE).exists()
    with pytest.raises(ValueError, match="orbax.*convert_cli"):
        checkpoints.load_params(str(tmp_path), "svrm")
    # Any directory without the port's file raises, never gives None.
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="convert_cli"):
        checkpoints.load_params(str(tmp_path), "empty")


def test_tree_keys_may_not_hold_the_separator(tmp_path):
    with pytest.raises(ValueError, match="separator"):
        checkpoints.save_params(str(tmp_path), "bad", {"a/b": np.zeros(1, np.float32)})


def test_convert_and_save_dinov2_matches_jax(tmp_path):
    from labelany3d_tpu.models.convert import convert_dinov2_vit as jax_convert
    from labelany3d_tpu.models.vit import ViTConfig as JViTConfig
    from labelany3d_tpu_torch.models.vit import ViTConfig

    grid = (4, 4)
    st = chip_smoke.SyntheticState(3)
    st.vit("", ViTConfig.tiny_test(num_register_tokens=1, pos_grid=grid), n_pos=16)
    ckpt = tmp_path / "dinov2.pth"
    torch.save({k: torch.from_numpy(v) for k, v in st.items()}, ckpt)
    cfg = ViTConfig.tiny_test(num_register_tokens=1, pos_grid=grid)
    path = checkpoints.convert_and_save_dinov2(str(ckpt), str(tmp_path / "store"), "dino",
                                               cfg, grid)
    assert path.endswith("dino")
    want = jax_convert(dict(st), JViTConfig.tiny_test(num_register_tokens=1, pos_grid=grid),
                       grid)
    _assert_same_tree(checkpoints.load_params(str(tmp_path / "store"), "dino"),
                      {k: v for k, v in want.items()})
