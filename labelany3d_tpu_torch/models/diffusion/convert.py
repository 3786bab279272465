"""Diffusers-name Stable Diffusion UNet / VAE / Zero123 -> Flax-layout trees.

Counterpart of `labelany3d_tpu/models/diffusion/convert.py`, the SDXL
`convert_mvd_unet` and the Hunyuan3D `convert_mvd` included. `UNet2D`,
`MVDUNet` and `AutoencoderKL` are graph-compatible with diffusers' modules, so
conversion is a pure name mapping into the Flax parameter tree, which
`models/weights.py::flax_to_state_dict` then carries into the port's
modules. `state`: name -> numpy array (or anything `np.asarray` takes).
"""

from __future__ import annotations

import numpy as np


def _lin(state: dict, pre: str) -> dict:
    w = np.asarray(state[pre + "weight"])
    out = {"kernel": np.ascontiguousarray(w.T)}
    if pre + "bias" in state:
        out["bias"] = np.asarray(state[pre + "bias"])
    return out


def _conv(state: dict, pre: str) -> dict:
    w = np.asarray(state[pre + "weight"])  # (out, in, kh, kw)
    return {"kernel": np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))),
            "bias": np.asarray(state[pre + "bias"])}


def _norm(state: dict, pre: str) -> dict:
    return {"scale": np.asarray(state[pre + "weight"]),
            "bias": np.asarray(state[pre + "bias"])}


def _resnet(state: dict, pre: str) -> dict:
    p = {
        "norm1": _norm(state, pre + "norm1."),
        "conv1": _conv(state, pre + "conv1."),
        "temb_proj": _lin(state, pre + "time_emb_proj."),
        "norm2": _norm(state, pre + "norm2."),
        "conv2": _conv(state, pre + "conv2."),
    }
    if pre + "conv_shortcut.weight" in state:
        p["skip"] = _conv(state, pre + "conv_shortcut.")
    return p


def _transformer(state: dict, pre: str) -> dict:
    tb = pre + "transformer_blocks.0."
    return {
        "norm": _norm(state, pre + "norm."),
        "proj_in": _conv(state, pre + "proj_in."),
        "ln1": _norm(state, tb + "norm1."),
        "self_q": _lin(state, tb + "attn1.to_q."),
        "self_k": _lin(state, tb + "attn1.to_k."),
        "self_v": _lin(state, tb + "attn1.to_v."),
        "self_proj": _lin(state, tb + "attn1.to_out.0."),
        "ln2": _norm(state, tb + "norm2."),
        "cross_q": _lin(state, tb + "attn2.to_q."),
        "cross_k": _lin(state, tb + "attn2.to_k."),
        "cross_v": _lin(state, tb + "attn2.to_v."),
        "cross_proj": _lin(state, tb + "attn2.to_out.0."),
        "ln3": _norm(state, tb + "norm3."),
        "geglu": _lin(state, tb + "ff.net.0.proj."),
        "ff_out": _lin(state, tb + "ff.net.2."),
        "proj_out": _conv(state, pre + "proj_out."),
    }


def _vae_res(state: dict, pre: str) -> dict:
    p = {
        "n1": _norm(state, pre + "norm1."),
        "c1": _conv(state, pre + "conv1."),
        "n2": _norm(state, pre + "norm2."),
        "c2": _conv(state, pre + "conv2."),
    }
    if pre + "conv_shortcut.weight" in state:
        p["skip"] = _conv(state, pre + "conv_shortcut.")
    return p


def _vae_attn(state: dict, pre: str) -> dict:
    return {
        "gn": _norm(state, pre + "group_norm."),
        "q": _lin(state, pre + "to_q."),
        "k": _lin(state, pre + "to_k."),
        "v": _lin(state, pre + "to_v."),
        "proj": _lin(state, pre + "to_out.0."),
    }


def convert_sd_vae(state: dict, cfg) -> dict:
    """diffusers `AutoencoderKL` state dict -> `{'encoder': ..., 'decoder':
    ...}` params for `vae.AutoencoderKL(cfg)`."""
    n = len(cfg.widths)
    enc: dict = {
        "in": _conv(state, "encoder.conv_in."),
        "mid_res1": _vae_res(state, "encoder.mid_block.resnets.0."),
        "mid_attn": _vae_attn(state, "encoder.mid_block.attentions.0."),
        "mid_res2": _vae_res(state, "encoder.mid_block.resnets.1."),
        "n_out": _norm(state, "encoder.conv_norm_out."),
        "out": _conv(state, "encoder.conv_out."),
        "quant": _conv(state, "quant_conv."),
    }
    for i in range(n):
        for r in range(cfg.layers_per_block):
            enc[f"res{i}_{r}"] = _vae_res(state, f"encoder.down_blocks.{i}.resnets.{r}.")
        if i < n - 1:
            enc[f"ds{i}"] = _conv(state, f"encoder.down_blocks.{i}.downsamplers.0.conv.")
    dec: dict = {
        "post_quant": _conv(state, "post_quant_conv."),
        "in": _conv(state, "decoder.conv_in."),
        "mid_res1": _vae_res(state, "decoder.mid_block.resnets.0."),
        "mid_attn": _vae_attn(state, "decoder.mid_block.attentions.0."),
        "mid_res2": _vae_res(state, "decoder.mid_block.resnets.1."),
        "n_out": _norm(state, "decoder.conv_norm_out."),
        "out": _conv(state, "decoder.conv_out."),
    }
    for j in range(n):  # decoder up_blocks[0] is the deepest level
        for r in range(cfg.layers_per_block + 1):
            dec[f"res{j}_{r}"] = _vae_res(state, f"decoder.up_blocks.{j}.resnets.{r}.")
        if j < n - 1:
            dec[f"us{j}"] = _conv(state, f"decoder.up_blocks.{j}.upsamplers.0.conv.")
    return {"encoder": enc, "decoder": dec}


def convert_sd_unet(state: dict, cfg) -> dict:
    """diffusers `UNet2DConditionModel` state dict -> Flax params for
    `unet.UNet2D(cfg)`. `state`: name -> numpy array."""
    n_levels = len(cfg.widths)
    p: dict = {
        "in_conv": _conv(state, "conv_in."),
        "t1": _lin(state, "time_embedding.linear_1."),
        "t2": _lin(state, "time_embedding.linear_2."),
        "mid_res1": _resnet(state, "mid_block.resnets.0."),
        "mid_attn": _transformer(state, "mid_block.attentions.0."),
        "mid_res2": _resnet(state, "mid_block.resnets.1."),
        "norm_out": _norm(state, "conv_norm_out."),
        "out_conv": _conv(state, "conv_out."),
    }
    for lvl in range(n_levels):
        pre = f"down_blocks.{lvl}."
        for i in range(cfg.num_res_blocks):
            p[f"down{lvl}_res{i}"] = _resnet(state, pre + f"resnets.{i}.")
            if lvl in cfg.attn_levels:
                p[f"down{lvl}_attn{i}"] = _transformer(state, pre + f"attentions.{i}.")
        if lvl < n_levels - 1:
            p[f"down{lvl}_ds"] = _conv(state, pre + "downsamplers.0.conv.")
    for u in range(n_levels):
        lvl = n_levels - 1 - u  # diffusers up_blocks[0] is the deepest level
        pre = f"up_blocks.{u}."
        for i in range(cfg.num_res_blocks + 1):
            p[f"up{lvl}_res{i}"] = _resnet(state, pre + f"resnets.{i}.")
            if lvl in cfg.attn_levels:
                p[f"up{lvl}_attn{i}"] = _transformer(state, pre + f"attentions.{i}.")
        if lvl > 0:
            p[f"up{lvl}_us"] = _conv(state, pre + "upsamplers.0.conv.")
    return p


def _transformer_sdxl(state: dict, pre: str, depth: int) -> dict:
    """SDXL `Transformer2DModel`: linear proj_in/out and `depth`
    transformer_blocks -> `mvd.MVDTransformer` params."""
    p = {
        "norm": _norm(state, pre + "norm."),
        "proj_in": _lin(state, pre + "proj_in."),
        "proj_out": _lin(state, pre + "proj_out."),
    }
    for d in range(depth):
        tb = pre + f"transformer_blocks.{d}."
        p.update({
            f"b{d}_ln1": _norm(state, tb + "norm1."),
            f"b{d}_self_q": _lin(state, tb + "attn1.to_q."),
            f"b{d}_self_k": _lin(state, tb + "attn1.to_k."),
            f"b{d}_self_v": _lin(state, tb + "attn1.to_v."),
            f"b{d}_self_proj": _lin(state, tb + "attn1.to_out.0."),
            f"b{d}_ln2": _norm(state, tb + "norm2."),
            f"b{d}_cross_q": _lin(state, tb + "attn2.to_q."),
            f"b{d}_cross_k": _lin(state, tb + "attn2.to_k."),
            f"b{d}_cross_v": _lin(state, tb + "attn2.to_v."),
            f"b{d}_cross_proj": _lin(state, tb + "attn2.to_out.0."),
            f"b{d}_ln3": _norm(state, tb + "norm3."),
            f"b{d}_geglu": _lin(state, tb + "ff.net.0.proj."),
            f"b{d}_ff_out": _lin(state, tb + "ff.net.2."),
        })
    return p


def convert_mvd_unet(state: dict, cfg) -> dict:
    """diffusers SDXL `UNet2DConditionModel` state dict (Hunyuan3D's
    `weights/mvd_std/unet`) -> Flax params for `mvd.MVDUNet(cfg)`."""
    n_levels = len(cfg.widths)
    p: dict = {
        "in_conv": _conv(state, "conv_in."),
        "t1": _lin(state, "time_embedding.linear_1."),
        "t2": _lin(state, "time_embedding.linear_2."),
        "add1": _lin(state, "add_embedding.linear_1."),
        "add2": _lin(state, "add_embedding.linear_2."),
        "mid_res1": _resnet(state, "mid_block.resnets.0."),
        "mid_attn": _transformer_sdxl(state, "mid_block.attentions.0.",
                                      cfg.transformer_depth[-1]),
        "mid_res2": _resnet(state, "mid_block.resnets.1."),
        "norm_out": _norm(state, "conv_norm_out."),
        "out_conv": _conv(state, "conv_out."),
    }
    for lvl in range(n_levels):
        pre = f"down_blocks.{lvl}."
        for i in range(cfg.num_res_blocks):
            p[f"down{lvl}_res{i}"] = _resnet(state, pre + f"resnets.{i}.")
            if lvl in cfg.attn_levels:
                p[f"down{lvl}_attn{i}"] = _transformer_sdxl(
                    state, pre + f"attentions.{i}.", cfg.transformer_depth[lvl])
        if lvl < n_levels - 1:
            p[f"down{lvl}_ds"] = _conv(state, pre + "downsamplers.0.conv.")
    for u in range(n_levels):
        lvl = n_levels - 1 - u  # diffusers up_blocks[0] is the deepest level
        pre = f"up_blocks.{u}."
        for i in range(cfg.num_res_blocks + 1):
            p[f"up{lvl}_res{i}"] = _resnet(state, pre + f"resnets.{i}.")
            if lvl in cfg.attn_levels:
                p[f"up{lvl}_attn{i}"] = _transformer_sdxl(
                    state, pre + f"attentions.{i}.", cfg.transformer_depth[lvl])
        if lvl > 0:
            p[f"up{lvl}_us"] = _conv(state, pre + "upsamplers.0.conv.")
    return p


def convert_mvd(unet_state: dict | None = None, vae_state: dict | None = None,
                vision_state: dict | None = None, vision2_state: dict | None = None,
                uc_text_emb=None, uc_text_emb_2=None, ramping_coefficients=None,
                unet_cfg=None, vae_cfg=None, vision_cfg=None, vision2_cfg=None,
                unet_cfg_json: dict | None = None) -> dict:
    """Assembled converter for the Hunyuan3D `weights/mvd_std` pipeline: the
    SDXL unet, the AutoencoderKL, two CLIPVisionModelWithProjection towers
    (ViT-L/14, ViT-bigG/14), the precomputed uc_text_emb{,_2} and the
    config's ramping_coefficients. Omitted components are left out. Returns
    Flax-layout trees for `MVDStdViews.set_params`."""
    from labelany3d_tpu_torch.models.diffusion.mvd import MVDUNetConfig
    from labelany3d_tpu_torch.models.diffusion.vae import VAEConfig

    out: dict = {}
    if unet_state is not None:
        if unet_cfg is None:
            unet_cfg = (MVDUNetConfig.from_hf_json(unet_cfg_json) if unet_cfg_json
                        else MVDUNetConfig())
        out["unet"] = convert_mvd_unet(unet_state, unet_cfg)
    if vae_state is not None:
        out["vae"] = convert_sd_vae(vae_state, vae_cfg or VAEConfig())
    if vision_state is not None or vision2_state is not None:
        from labelany3d_tpu_torch.models.clip import CLIPVisionConfig, convert_clip_vision

        if vision_state is not None:
            out["vision"] = convert_clip_vision(vision_state,
                                                vision_cfg or CLIPVisionConfig.vitl14())
        if vision2_state is not None:
            out["vision_2"] = convert_clip_vision(vision2_state,
                                                  vision2_cfg or CLIPVisionConfig.bigg14())
    for key, val in (("uc_text_emb", uc_text_emb), ("uc_text_emb_2", uc_text_emb_2),
                     ("ramping_coefficients", ramping_coefficients)):
        if val is not None:
            out[key] = np.asarray(val, np.float32)
    return out


def convert_zero123(
    unet_state: dict,
    vae_state: dict | None = None,
    vision_state: dict | None = None,
    cc_state: dict | None = None,
    unet_cfg=None,
    vae_cfg=None,
    vision_cfg=None,
) -> dict:
    """Assembled converter for `ashawkey/zero123-xl-diffusers`, a
    diffusers-format pipeline with four weighted components:
      * `unet/` — UNet2DConditionModel with an 8-channel conv_in (4 noise
        + 4 reference-image latent channels, concatenated like
        `Zero123NovelView.generate`);
      * `vae/` — AutoencoderKL;
      * `image_encoder/` — CLIPVisionModelWithProjection (ViT-L/14);
      * `clip_camera_projection/` (a.k.a. cc_projection) —
        `CLIPCameraProjection.proj`: Linear(768 + 4 -> 768).

    Pass each component's state dict (numpy); omitted components are left
    out of the result. Returns {"unet", "vae", "vision", "cc"} Flax trees
    for `Zero123NovelView.set_params`.
    """
    import dataclasses as _dc

    from labelany3d_tpu_torch.models.diffusion.unet import UNetConfig
    from labelany3d_tpu_torch.models.diffusion.vae import VAEConfig

    out: dict = {}
    if unet_state is not None:
        if unet_cfg is None:
            unet_cfg = _dc.replace(UNetConfig(), in_channels=8)
        out["unet"] = convert_sd_unet(unet_state, unet_cfg)
    if vae_state is not None:
        out["vae"] = convert_sd_vae(vae_state, vae_cfg or VAEConfig())
    if vision_state is not None:
        from labelany3d_tpu_torch.models.clip import CLIPVisionConfig, convert_clip_vision

        out["vision"] = convert_clip_vision(
            vision_state, vision_cfg or CLIPVisionConfig.vitl14())
    if cc_state is not None:
        key = "proj.weight" if "proj.weight" in cc_state else "cc_projection.weight"
        out["cc"] = {"proj": {
            "kernel": np.ascontiguousarray(np.asarray(cc_state[key]).T),
            "bias": np.asarray(cc_state[key[:-6] + "bias"]),
        }}
    return out
