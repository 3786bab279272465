"""The port's convert CLI (`models/convert_cli.py`) against the JAX one.

Every one of the 20 entries of the JAX `CONVERTERS` runs through the port's
`main` at `--tiny`, on a seeded state dict in the release's layout
(`chip_smoke.released_*_state`, as the converter tests draw them)
written to a file (`.safetensors` through the port's codec, or a torch
`.pt`, alternately). The store it writes must hold, exactly (values, dtypes
and keys), the tree of the JAX entry `CONVERTERS[name](state, True)`.

zero123's file entry converts a full-width UNet whatever `--tiny` says, in
both packages, so its case goes through the directory loader with the
camera projection alone; the entry's component path at a tiny UNet config
is held in `test_zero123_components_match_jax`. The mvd directory loader
(UNet, its config.json, the raw uc_text_emb tensors and the ramping
coefficients) and both `SystemExit`s are held too.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
from labelany3d_tpu.models import convert_cli as jcli
from labelany3d_tpu_torch.models import convert_cli as tcli
from labelany3d_tpu_torch.models.checkpoints import load_params
from labelany3d_tpu_torch.utils import safetensors_io

torch.set_num_threads(1)


def _moge():
    from labelany3d_tpu_torch.models.moge import MoGeConfig

    cfg = MoGeConfig.tiny_reference_test()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, pos_grid=(4, 4)))
    return chip_smoke.released_moge_state(cfg)


def _depth_pro():
    from labelany3d_tpu_torch.models.depth_pro import DepthPro35Config

    return chip_smoke.released_depth_pro_state(DepthPro35Config.tiny_test())


def _matcher():
    from labelany3d_tpu_torch.models.matcher import MatcherConfig

    return chip_smoke.released_mast3r_state(MatcherConfig.tiny_test())


def _sd_unet():
    from labelany3d_tpu_torch.models.diffusion import UNetConfig

    return chip_smoke.released_sd_unet_state(UNetConfig.tiny_test())


def _sd_vae():
    from labelany3d_tpu_torch.models.diffusion import VAEConfig

    return chip_smoke.released_sd_vae_state(VAEConfig.tiny_test())


def _clip_text():
    from labelany3d_tpu_torch.models.clip import CLIPTextConfig

    return chip_smoke.released_clip_text_state(CLIPTextConfig.tiny_test())


def _clip_vision():
    from labelany3d_tpu_torch.models.clip import CLIPVisionConfig

    return chip_smoke.released_clip_vision_state(CLIPVisionConfig.tiny_test())


def _sam():
    from labelany3d_tpu_torch.models.sam import SamConfig

    return chip_smoke.released_sam_state(SamConfig.tiny_test())


def _segformer():
    from labelany3d_tpu_torch.models.segformer import SegFormerConfig

    return chip_smoke.released_segformer_state(SegFormerConfig.tiny_test())


def _isnet():
    from labelany3d_tpu_torch.models.saliency import ISNetConfig

    return chip_smoke.released_isnet_state(ISNetConfig.tiny_test())


def _noise_predictor():
    from labelany3d_tpu_torch.models.diffusion.noise_predictor import NoisePredictorConfig

    return chip_smoke.released_noise_predictor_state(NoisePredictorConfig.tiny_test())


def _svrm():
    from labelany3d_tpu_torch.models.svrm import SVRMConfig

    return chip_smoke.released_svrm_state(SVRMConfig.tiny_test())


def _mvd():
    from labelany3d_tpu_torch.models.diffusion.mvd import MVDUNetConfig

    return chip_smoke.released_mvd_unet_state(MVDUNetConfig.tiny_test())


def _trellis_cond():
    from labelany3d_tpu_torch.models.vit import ViTConfig

    st = chip_smoke.SyntheticState(40)
    st.vit("", ViTConfig.tiny_test(pos_grid=(4, 4)), n_pos=16)
    return st


def _trellis(component):
    def make():
        from labelany3d_tpu_torch.models.trellis import TrellisPipelineConfig

        cfg = TrellisPipelineConfig.tiny_test()
        cfg = dataclasses.replace(cfg, cond_backbone=dataclasses.replace(
            cfg.cond_backbone, pos_grid=(4, 4)))
        for name, state in chip_smoke.released_trellis_states(cfg):
            if name == component:
                return state
    return make


STATES = {
    "moge": _moge, "depth_pro": _depth_pro, "matcher": _matcher, "sd_unet": _sd_unet,
    "sd_vae": _sd_vae, "clip_text": _clip_text, "clip_vision": _clip_vision, "sam": _sam,
    "segformer": _segformer, "isnet": _isnet, "noise_predictor": _noise_predictor,
    "trellis_cond": _trellis_cond, "trellis_ss_flow": _trellis("ss"),
    "trellis_ss_dec": _trellis("ss_dec"), "trellis_slat_flow": _trellis("slat"),
    "trellis_slat_gs": _trellis("gs"), "trellis_slat_mesh": _trellis("mesh"),
    "svrm": _svrm, "mvd": _mvd,
}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def assert_same_tree(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:8]
    for k, wv in w.items():
        wv, gv = np.asarray(wv), np.asarray(g[k])
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, (k, gv.dtype, wv.dtype)
        np.testing.assert_array_equal(gv, wv, err_msg="/".join(k))


def _write(state: dict, path):
    if str(path).endswith(".safetensors"):
        safetensors_io.save_file(dict(state), str(path))
    else:
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, path)


def test_the_cli_has_every_jax_entry():
    assert sorted(tcli.CONVERTERS) == sorted(jcli.CONVERTERS)
    assert len(tcli.CONVERTERS) == 20


@pytest.mark.parametrize("name", sorted(jcli.CONVERTERS))
def test_cli_entry_writes_the_jax_tree(name, tmp_path, capsys):
    store = tmp_path / "store"
    if name == "zero123":
        root = tmp_path / "zero123"
        (root / "cc_projection").mkdir(parents=True)
        safetensors_io.save_file(dict(chip_smoke.released_cc_state(16, 8)),
                                 str(root / "cc_projection" / "model.safetensors"))
        path = tcli.main([name, str(root), "--out", str(store), "--tiny"])
        want = jcli.CONVERTERS[name](jcli._load_zero123_dir(str(root)), True)
    else:
        state = STATES[name]()
        suffix = ".safetensors" if sorted(jcli.CONVERTERS).index(name) % 2 else ".pt"
        ckpt = tmp_path / f"{name}{suffix}"
        _write(state, ckpt)
        path = tcli.main([name, str(ckpt), "--out", str(store), "--tiny"])
        want = jcli.CONVERTERS[name](dict(state), True)
    assert path == str(store / name)
    got = load_params(str(store), name)
    assert_same_tree(got, want)
    n = sum(np.asarray(v).size for _, v in _flat(want))
    assert f"{name}: {n / 1e6:.1f}M params -> {path}" in capsys.readouterr().out


def test_cli_name_and_config_json(tmp_path):
    """`--name` picks the store's entry; `--config` passes a TRELLIS model's
    JSON to the entry's config reader, as in the JAX CLI."""
    from labelany3d_tpu_torch.models.trellis import SLatDecoderConfig

    state = STATES["trellis_slat_gs"]()
    ckpt = tmp_path / "slat_dec_gs.safetensors"
    _write(state, ckpt)
    cfg = SLatDecoderConfig.tiny_test()
    args = {"resolution": cfg.resolution, "model_channels": cfg.model_channels,
            "latent_channels": cfg.latent_channels, "num_blocks": cfg.num_blocks,
            "num_heads": cfg.num_heads, "window_size": cfg.window_size}
    (tmp_path / "cfg.json").write_text(json.dumps({"name": "SLatGaussianDecoder",
                                                   "args": args}))
    path = tcli.main(["trellis_slat_gs", str(ckpt), "--out", str(tmp_path / "s"), "--name",
                      "gs_other", "--config", str(tmp_path / "cfg.json")])
    assert path.endswith("gs_other")
    want = jcli.CONVERTERS["trellis_slat_gs"](dict(state), False,
                                              cfg_json=json.loads((tmp_path / "cfg.json")
                                                                  .read_text()))
    assert_same_tree(load_params(str(tmp_path / "s"), "gs_other"), want)


def test_nested_state_dict_and_bfloat16_safetensors(tmp_path):
    """A `.pt` nesting its weights under 'state_dict' (InvSR's noise
    predictor) converts as the bare dict (the JAX `_load_state` leaves the
    nesting in place, F14); a bfloat16 `.safetensors` is widened to float32
    exactly before conversion."""
    state = STATES["noise_predictor"]()
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}},
               tmp_path / "np.pth")
    assert set(jcli._load_state(str(tmp_path / "np.pth"))) == {"state_dict"}  # F14
    assert_same_tree(tcli._load_state(str(tmp_path / "np.pth")), dict(state))
    tcli.main(["noise_predictor", str(tmp_path / "np.pth"), "--out", str(tmp_path / "a"),
               "--tiny"])
    assert_same_tree(load_params(str(tmp_path / "a"), "noise_predictor"),
                     jcli.CONVERTERS["noise_predictor"](dict(state), True))

    bf = {k: torch.from_numpy(v).bfloat16() for k, v in STATES["isnet"]().items()}
    safetensors_io.save_file(bf, str(tmp_path / "isnet.safetensors"))
    tcli.main(["isnet", str(tmp_path / "isnet.safetensors"), "--out", str(tmp_path / "b"),
               "--tiny"])
    assert_same_tree(load_params(str(tmp_path / "b"), "isnet"), jcli.CONVERTERS["isnet"](
        {k: v.float().numpy() for k, v in bf.items()}, True))


def test_zero123_components_match_jax():
    from labelany3d_tpu.models.diffusion import UNetConfig as JUNetConfig
    from labelany3d_tpu_torch.models.diffusion import UNetConfig

    unet = chip_smoke.with_conv_in(_sd_unet(), 8)
    cc = chip_smoke.released_cc_state(16, 8)
    got = tcli.CONVERTERS["zero123"]({"components": {
        "unet_state": unet, "cc_state": cc,
        "unet_cfg": dataclasses.replace(UNetConfig.tiny_test(), in_channels=8)}}, True)
    want = jcli.CONVERTERS["zero123"]({"components": {
        "unet_state": unet, "cc_state": cc,
        "unet_cfg": dataclasses.replace(JUNetConfig.tiny_test(), in_channels=8)}}, True)
    assert set(got) == {"unet", "cc"}
    assert_same_tree(got, want)


def test_mvd_directory_loader_matches_jax(tmp_path):
    from labelany3d_tpu_torch.models.diffusion.mvd import MVDUNetConfig

    cfg = MVDUNetConfig.tiny_test()
    root = tmp_path / "mvd_std"
    (root / "unet").mkdir(parents=True)
    safetensors_io.save_file(dict(_mvd()), str(root / "unet" /
                                               "diffusion_pytorch_model.safetensors"))
    (root / "unet" / "config.json").write_text(json.dumps({
        "block_out_channels": list(cfg.widths),
        "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D"],
        "transformer_layers_per_block": list(cfg.transformer_depth),
        "attention_head_dim": [w // cfg.head_dim for w in cfg.widths],
        "layers_per_block": cfg.num_res_blocks,
        "cross_attention_dim": cfg.context_dim,
        "projection_class_embeddings_input_dim":
            cfg.pooled_dim + 6 * cfg.addition_time_embed_dim,
        "addition_time_embed_dim": cfg.addition_time_embed_dim,
        "in_channels": cfg.in_channels, "out_channels": cfg.out_channels}))
    g = torch.Generator().manual_seed(5)
    torch.save(torch.randn(1, 7, cfg.context_dim, generator=g), root / "uc_text_emb.pt")
    torch.save(torch.randn(1, cfg.pooled_dim, generator=g), root / "uc_text_emb_2.pt")
    (root / "model_index.json").write_text(json.dumps(
        {"ramping_coefficients": list(np.linspace(0, 1, 7))}))

    path = tcli.main(["mvd", str(root), "--out", str(tmp_path / "store"), "--tiny"])
    got = load_params(str(tmp_path / "store"), "mvd")
    assert path.endswith("mvd")
    assert set(got) == {"unet", "uc_text_emb", "uc_text_emb_2", "ramping_coefficients"}
    assert_same_tree(got, jcli.CONVERTERS["mvd"](jcli._load_mvd_dir(str(root)), True))


def test_cli_exits_on_an_unknown_model_or_a_directory_it_does_not_take(tmp_path):
    with pytest.raises(SystemExit):
        tcli.main(["nope", "x.pt"])
    with pytest.raises(SystemExit, match="expects a checkpoint FILE"):
        tcli.main(["svrm", str(tmp_path), "--out", str(tmp_path / "s")])
