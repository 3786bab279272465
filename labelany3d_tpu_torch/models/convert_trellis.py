"""Torch -> Flax-layout weight conversion for the TRELLIS models.

The port's own copy of `labelany3d_tpu/models/convert_trellis.py`: it maps
the released `JeffreyXiang/TRELLIS-image-large` state dicts (numpy arrays
by torch name) onto Flax-layout trees, which
`models/weights.py::flax_to_state_dict` then carries into the port's
modules:

  * `sparse_structure_flow.py` (SS flow DiT)      -> convert_trellis_ss_flow
  * `sparse_structure_vae.py` (conv decoder)      -> convert_trellis_ss_decoder
  * `structured_latent_flow.py` (SLat UNet DiT)   -> convert_trellis_slat_flow
  * `structured_latent_vae/decoder_gs.py`         -> convert_trellis_slat_gs
  * `structured_latent_vae/decoder_mesh.py`       -> convert_trellis_slat_mesh
  * torch.hub dinov2 (image conditioner)          -> convert_trellis_cond

The `*_config_from_json` readers build the port's configs from each model's
released `<name>.json`.

Layout notes:
  * fused attention projections are split: `to_qkv` rows -> q/k/v kernels,
    `to_kv` rows -> k/v (the same products as the fused matmul);
  * spconv `SubMConv3d.weight` (out, k, k, k, in) -> (k, k, k, in, out), the
    same spatial axis order;
  * `MultiHeadRMSNorm.gamma` is (heads, head_dim) on both sides;
  * non-affine norms (norm1/norm3/out-norm) carry no weights anywhere.
"""

from __future__ import annotations

import numpy as np

from labelany3d_tpu_torch.models.trellis.decoders import (
    GaussianRepConfig,
    SLatDecoderConfig,
    flexicubes_channels,
)
from labelany3d_tpu_torch.models.trellis.dit import DiTConfig
from labelany3d_tpu_torch.models.trellis.slat import SLatConfig
from labelany3d_tpu_torch.models.trellis.sparse_structure import (
    SparseStructureConfig,
    SSDecoderConfig,
)


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _linear(state: dict, pre: str) -> dict:
    p = {"kernel": _t(state[pre + "weight"])}
    if pre + "bias" in state:
        p["bias"] = np.asarray(state[pre + "bias"])
    return p


def _ln(state: dict, pre: str) -> dict:
    return {"scale": np.asarray(state[pre + "weight"]),
            "bias": np.asarray(state[pre + "bias"])}


def _conv3d_k(w) -> np.ndarray:
    """torch Conv3d (out, in, k, k, k) -> flax (k, k, k, in, out)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 4, 1, 0)))


def _conv3d(state: dict, pre: str) -> dict:
    return {"kernel": _conv3d_k(state[pre + "weight"]),
            "bias": np.asarray(state[pre + "bias"])}


def _spconv_k(w) -> np.ndarray:
    """spconv SubMConv3d weight (out, k, k, k, in) -> (k, k, k, in, out)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (1, 2, 3, 4, 0)))


def _spconv(state: dict, pre: str) -> dict:
    # The SparseConv3d wrapper registers the spconv module as `.conv`;
    # accept both `<pre>conv.weight` and a bare `<pre>weight`.
    key = pre + "conv.weight" if pre + "conv.weight" in state else pre + "weight"
    bkey = key[:-6] + "bias"
    return {"kernel": _spconv_k(state[key]), "bias": np.asarray(state[bkey])}


def _num_heads(args: dict) -> int:
    if args.get("num_heads"):
        return args["num_heads"]
    return args["model_channels"] // args.get("num_head_channels", 64)


def _split3(w, b):
    """Fused to_qkv (3C, C_in) -> three {kernel, bias} dicts."""
    w = np.asarray(w)
    c = w.shape[0] // 3
    out = []
    for i in range(3):
        d = {"kernel": _t(w[i * c:(i + 1) * c])}
        if b is not None:
            d["bias"] = np.asarray(b)[i * c:(i + 1) * c]
        out.append(d)
    return out


def _split2(w, b):
    w = np.asarray(w)
    c = w.shape[0] // 2
    out = []
    for i in range(2):
        d = {"kernel": _t(w[i * c:(i + 1) * c])}
        if b is not None:
            d["bias"] = np.asarray(b)[i * c:(i + 1) * c]
        out.append(d)
    return out


def _attention(state: dict, pre: str, cross: bool) -> dict:
    """MultiHeadAttention (`attention/modules.py:65-175`) -> our Attention."""
    p: dict = {}
    if cross:
        p["q"] = _linear(state, pre + "to_q.")
        k, v = _split2(state[pre + "to_kv.weight"], state.get(pre + "to_kv.bias"))
        p["k"], p["v"] = k, v
    else:
        q, k, v = _split3(state[pre + "to_qkv.weight"], state.get(pre + "to_qkv.bias"))
        p["q"], p["k"], p["v"] = q, k, v
    p["proj"] = _linear(state, pre + "to_out.")
    if pre + "q_rms_norm.gamma" in state:
        p["q_rms"] = {"gamma": np.asarray(state[pre + "q_rms_norm.gamma"])}
        p["k_rms"] = {"gamma": np.asarray(state[pre + "k_rms_norm.gamma"])}
    return p


def _dit_block(state: dict, pre: str, share_mod: bool) -> dict:
    """ModulatedTransformerCrossBlock -> DiTBlock params."""
    blk: dict = {
        "norm2": _ln(state, pre + "norm2."),
        "self_attn": _attention(state, pre + "self_attn.", cross=False),
        "cross_attn": _attention(state, pre + "cross_attn.", cross=True),
        "mlp": {"fc1": _linear(state, pre + "mlp.mlp.0."),
                "fc2": _linear(state, pre + "mlp.mlp.2.")},
    }
    if not share_mod:
        blk["adaln"] = {"mod": _linear(state, pre + "adaLN_modulation.1.")}
    return blk


def _t_embedder(state: dict, pre: str = "t_embedder.") -> dict:
    return {"fc1": _linear(state, pre + "mlp.0."),
            "fc2": _linear(state, pre + "mlp.2.")}


# ---------------------------------------------------------------------------
# Sparse-structure flow + decoder
# ---------------------------------------------------------------------------


def ss_flow_config_from_json(d: dict) -> SparseStructureConfig:
    """Build SparseStructureConfig from the HF model json (`args` of
    `SparseStructureFlowModel`)."""
    args = d.get("args", d)
    return SparseStructureConfig(
        latent_res=args["resolution"],
        latent_channels=args["in_channels"],
        out_channels=args["out_channels"],
        patch_size=args.get("patch_size", 1),
        dit=DiTConfig(
            width=args["model_channels"],
            depth=args["num_blocks"],
            num_heads=_num_heads(args),
            mlp_ratio=args.get("mlp_ratio", 4.0),
            cond_dim=args["cond_channels"],
            qk_rms_norm=args.get("qk_rms_norm", False),
            qk_rms_norm_cross=args.get("qk_rms_norm_cross", False),
            share_mod=args.get("share_mod", False),
        ),
    )


def convert_trellis_ss_flow(state: dict, cfg: SparseStructureConfig) -> dict:
    dit = cfg.dit
    p: dict = {
        "input_layer": _linear(state, "input_layer."),
        "t_embedder": _t_embedder(state),
        "out_layer": _linear(state, "out_layer."),
    }
    if dit.share_mod:
        p["adaln"] = {"mod": _linear(state, "adaLN_modulation.1.")}
    for i in range(dit.depth):
        p[f"block{i}"] = _dit_block(state, f"blocks.{i}.", dit.share_mod)
    return p


def ss_decoder_config_from_json(d: dict) -> SSDecoderConfig:
    args = d.get("args", d)
    return SSDecoderConfig(
        latent_channels=args["latent_channels"],
        out_channels=args["out_channels"],
        channels=tuple(args["channels"]),
        num_res_blocks=args["num_res_blocks"],
        num_res_blocks_middle=args.get("num_res_blocks_middle", 2),
        norm_type=args.get("norm_type", "layer"),
    )


def _res_block3d(state: dict, pre: str, has_skip: bool) -> dict:
    blk = {
        "norm1": _ln(state, pre + "norm1."),
        "conv1": _conv3d(state, pre + "conv1."),
        "norm2": _ln(state, pre + "norm2."),
        "conv2": _conv3d(state, pre + "conv2."),
    }
    if has_skip:
        blk["skip"] = _conv3d(state, pre + "skip_connection.")
    return blk


def convert_trellis_ss_decoder(state: dict, cfg: SSDecoderConfig) -> dict:
    p: dict = {
        "input_layer": _conv3d(state, "input_layer."),
        "norm_out": _ln(state, "out_layer.0."),
        "out_layer": _conv3d(state, "out_layer.2."),
    }
    for m in range(cfg.num_res_blocks_middle):
        p[f"middle{m}"] = _res_block3d(state, f"middle_block.{m}.", False)
    idx = 0
    for i, _ in enumerate(cfg.channels):
        for j in range(cfg.num_res_blocks):
            p[f"stage{i}_res{j}"] = _res_block3d(state, f"blocks.{idx}.", False)
            idx += 1
        if i < len(cfg.channels) - 1:
            p[f"stage{i}_up"] = _conv3d(state, f"blocks.{idx}.conv.")
            idx += 1
    return p


# ---------------------------------------------------------------------------
# SLat flow (UNet + DiT)
# ---------------------------------------------------------------------------


def slat_flow_config_from_json(d: dict) -> SLatConfig:
    args = d.get("args", d)
    return SLatConfig(
        resolution=args["resolution"],
        latent_channels=args["in_channels"],
        out_channels=args["out_channels"],
        io_block_channels=tuple(args["io_block_channels"]),
        num_io_res_blocks=args.get("num_io_res_blocks", 2),
        use_skip_connection=args.get("use_skip_connection", True),
        dit=DiTConfig(
            width=args["model_channels"],
            depth=args["num_blocks"],
            num_heads=_num_heads(args),
            mlp_ratio=args.get("mlp_ratio", 4.0),
            cond_dim=args["cond_channels"],
            qk_rms_norm=args.get("qk_rms_norm", False),
            qk_rms_norm_cross=args.get("qk_rms_norm_cross", False),
            share_mod=args.get("share_mod", False),
        ),
    )


def _sparse_res_block(state: dict, pre: str, ch_change: bool) -> dict:
    blk = {
        "norm1": _ln(state, pre + "norm1."),
        "conv1": _spconv(state, pre + "conv1."),
        "conv2": _spconv(state, pre + "conv2."),
        "emb": _linear(state, pre + "emb_layers.1."),
    }
    if ch_change:
        blk["skip"] = _linear(state, pre + "skip_connection.")
    return blk


def convert_trellis_slat_flow(state: dict, cfg: SLatConfig) -> dict:
    dit = cfg.dit
    p: dict = {
        "input_layer": _linear(state, "input_layer."),
        "t_embedder": _t_embedder(state),
        "out_layer": _linear(state, "out_layer."),
    }
    if dit.share_mod:
        p["adaln"] = {"mod": _linear(state, "adaLN_modulation.1.")}
    io = list(cfg.io_block_channels)
    j = 0
    for chs, next_chs in zip(io, io[1:] + [dit.width]):
        for _ in range(cfg.num_io_res_blocks - 1):
            p[f"in{j}"] = _sparse_res_block(state, f"input_blocks.{j}.", False)
            j += 1
        p[f"in{j}"] = _sparse_res_block(state, f"input_blocks.{j}.",
                                        chs != next_chs)
        j += 1
    for i in range(dit.depth):
        p[f"block{i}"] = _dit_block(state, f"blocks.{i}.", dit.share_mod)
    j = 0
    for chs, prev_chs in zip(reversed(io), [dit.width] + list(reversed(io[1:]))):
        in_ch = prev_chs * 2 if cfg.use_skip_connection else prev_chs
        p[f"out{j}"] = _sparse_res_block(state, f"out_blocks.{j}.", in_ch != chs)
        j += 1
        for _ in range(cfg.num_io_res_blocks - 1):
            in_ch = chs * 2 if cfg.use_skip_connection else chs
            p[f"out{j}"] = _sparse_res_block(state, f"out_blocks.{j}.", in_ch != chs)
            j += 1
    return p


# ---------------------------------------------------------------------------
# SLat VAE decoders
# ---------------------------------------------------------------------------


def slat_decoder_config_from_json(d: dict) -> SLatDecoderConfig:
    args = d.get("args", d)
    return SLatDecoderConfig(
        resolution=args["resolution"],
        latent_channels=args["latent_channels"],
        model_channels=args["model_channels"],
        num_blocks=args["num_blocks"],
        num_heads=_num_heads(args),
        mlp_ratio=args.get("mlp_ratio", 4.0),
        window_size=args.get("window_size", 8),
        qk_rms_norm=args.get("qk_rms_norm", False),
    )


def gs_rep_config_from_json(d: dict) -> GaussianRepConfig:
    rep = d.get("args", d).get("representation_config", d)
    lr = rep.get("lr", {})
    return GaussianRepConfig(
        num_gaussians=rep.get("num_gaussians", 32),
        voxel_size=rep.get("voxel_size", 1.5),
        perturb_offset=rep.get("perturb_offset", True),
        lr_xyz=lr.get("_xyz", 1.0),
        lr_features_dc=lr.get("_features_dc", 1.0),
        lr_scaling=lr.get("_scaling", 1.0),
        lr_rotation=lr.get("_rotation", 0.1),
        lr_opacity=lr.get("_opacity", 1.0),
        scaling_bias=rep.get("scaling_bias", 4e-3),
        opacity_bias=rep.get("opacity_bias", 0.1),
        min_kernel_size=rep.get("3d_filter_kernel_size", 2e-3),
        scaling_activation=rep.get("scaling_activation", "softplus"),
    )


def _transformer_block(state: dict, pre: str) -> dict:
    return {
        "attn": _attention(state, pre + "attn.", cross=False),
        "mlp": {"fc1": _linear(state, pre + "mlp.mlp.0."),
                "fc2": _linear(state, pre + "mlp.mlp.2.")},
    }


def _torso(state: dict, cfg: SLatDecoderConfig) -> dict:
    p: dict = {"input_layer": _linear(state, "input_layer.")}
    for i in range(cfg.num_blocks):
        p[f"block{i}"] = _transformer_block(state, f"blocks.{i}.")
    return p


def convert_trellis_slat_gs(state: dict, cfg: SLatDecoderConfig) -> dict:
    return {
        "torso": _torso(state, cfg),
        "out_layer": _linear(state, "out_layer."),
    }


def _gn(state: dict, pre: str) -> dict:
    return {"scale": np.asarray(state[pre + "weight"]),
            "bias": np.asarray(state[pre + "bias"])}


def _subdivide_block(state: dict, pre: str, ch_change: bool) -> dict:
    blk = {
        "norm_in": _gn(state, pre + "act_layers.0."),
        "conv1": _spconv(state, pre + "out_layers.0."),
        "norm_mid": _gn(state, pre + "out_layers.1."),
        "conv2": _spconv(state, pre + "out_layers.3."),
    }
    if ch_change:
        # 1^3 sparse conv == per-voxel linear.
        key = (pre + "skip_connection.conv.weight"
               if pre + "skip_connection.conv.weight" in state
               else pre + "skip_connection.weight")
        w = np.asarray(state[key])          # (out, 1, 1, 1, in)
        blk["skip"] = {"kernel": _t(w.reshape(w.shape[0], w.shape[-1]))}
        bkey = key[:-6] + "bias"
        if bkey in state:
            blk["skip"]["bias"] = np.asarray(state[bkey])
    return blk


def convert_trellis_slat_mesh(state: dict, cfg: SLatDecoderConfig) -> dict:
    return {
        "torso": _torso(state, cfg),
        "up0": _subdivide_block(state, "upsample.0.", True),
        "up1": _subdivide_block(state, "upsample.1.", True),
        "out_layer": _linear(state, "out_layer."),
    }


# ---------------------------------------------------------------------------
# Conditioner (DINOv2 via torch.hub)
# ---------------------------------------------------------------------------


def cond_backbone_config(name: str = "dinov2_vitl14_reg"):
    """ViTConfig for the torch.hub DINOv2 conditioner named in the released
    pipeline.json."""
    import dataclasses

    from labelany3d_tpu_torch.models.vit import ViTConfig

    grid = (37, 37)  # 518 / 14
    if "vitg14" in name:
        cfg = ViTConfig.giant(pos_grid=grid)
    elif "vitl14" in name:
        cfg = ViTConfig.large(pos_grid=grid)
    elif "vitb14" in name:
        cfg = ViTConfig.base(pos_grid=grid)
    else:
        raise ValueError(f"unknown dinov2 variant: {name}")
    if name.endswith("_reg"):
        cfg = dataclasses.replace(cfg, num_register_tokens=4)
    return cfg


def convert_trellis_cond(state: dict, cfg=None, name: str = "dinov2_vitl14_reg") -> dict:
    """DINOv2 conditioner checkpoint -> Flax-layout ViT params."""
    from labelany3d_tpu_torch.models.convert import convert_dinov2_vit

    cfg = cfg or cond_backbone_config(name)
    grid = cfg.pos_grid or (37, 37)
    return convert_dinov2_vit(state, cfg, grid)


def mesh_out_channels(use_color: bool = True) -> int:
    return flexicubes_channels(use_color)
