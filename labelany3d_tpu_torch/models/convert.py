"""Torch checkpoint -> Flax-layout parameter trees for the port's models.

The port's own copy of the JAX package's converters
(`labelany3d_tpu/models/convert.py`), so a released torch checkpoint
reaches a port model through the same name mapping as it reaches the JAX
package:

    state = load_torch_checkpoint("moge-vitl.pt")
    tree = convert_moge_checkpoint(state, MoGeConfig.vitl(), (37, 37))
    model.load_state_dict(flax_to_state_dict(tree, model))

(`models/weights.py::flax_to_state_dict` then maps the Flax tree onto the
port model's parameters.) Conversion needs numpy arrays only.

Mapping notes:
  * torch Linear weight (out, in) -> flax kernel (in, out) (transpose);
  * patch_embed.proj.weight (C, 3, p, p) -> Conv kernel (p, p, 3, C);
  * DINOv2's pos_embed carries a cls entry; the ViT adds positions to patch
    tokens only, so the cls position is folded into the cls token
    (mathematically identical for a frozen checkpoint);
  * LayerScale gamma -> ls1/ls2.gamma;
  * torch ConvTranspose2d weight (in, out, kh, kw) -> flax kernel
    (kh, kw, in, out), flipped in both spatial axes.
"""

from __future__ import annotations

import numpy as np


def _t(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def convert_dinov2_vit(state: dict, cfg, grid_hw: tuple[int, int]) -> dict:
    """DINOv2-style torch state dict -> Flax params for `ViT(cfg)`.

    Args:
      state: name -> numpy array (torch tensors: pass `.numpy()`).
      cfg: matching `models.vit.ViTConfig` (width/depth/heads/patch/swiglu
        agree; a SwiGLU config reads `mlp.w12` and `mlp.w3`).
      grid_hw: (gh, gw) token grid of the checkpoint's pos_embed.
    """
    gh, gw = grid_hw
    p: dict = {}

    pe = np.asarray(state["patch_embed.proj.weight"])  # (C, 3, p, p)
    p["patch_embed"] = {
        "kernel": np.transpose(pe, (2, 3, 1, 0)),
        "bias": np.asarray(state["patch_embed.proj.bias"]),
    }

    pos = np.asarray(state["pos_embed"])  # (1, 1+reg+N, C) or (1, N, C)
    n_prefix = pos.shape[1] - gh * gw
    patch_pos = pos[:, n_prefix:].reshape(1, gh, gw, cfg.width)
    p["pos_embed"] = patch_pos

    if cfg.use_class_token:
        cls = np.asarray(state["cls_token"])
        if n_prefix >= 1:
            cls = cls + pos[:, :1]  # fold the cls position in
        p["cls_token"] = cls
    if cfg.num_register_tokens:
        p["register_tokens"] = np.asarray(state["register_tokens"])

    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        blk: dict = {
            "norm1": {"scale": np.asarray(state[pre + "norm1.weight"]),
                      "bias": np.asarray(state[pre + "norm1.bias"])},
            "norm2": {"scale": np.asarray(state[pre + "norm2.weight"]),
                      "bias": np.asarray(state[pre + "norm2.bias"])},
            "attn": {
                "qkv": {"kernel": _t(state[pre + "attn.qkv.weight"]),
                        "bias": np.asarray(state[pre + "attn.qkv.bias"])},
                "proj": {"kernel": _t(state[pre + "attn.proj.weight"]),
                         "bias": np.asarray(state[pre + "attn.proj.bias"])},
            },
        }
        names = ("w12", "w3") if cfg.swiglu else ("fc1", "fc2")
        blk["mlp"] = {n: {"kernel": _t(state[pre + f"mlp.{n}.weight"]),
                          "bias": np.asarray(state[pre + f"mlp.{n}.bias"])} for n in names}
        if cfg.layerscale_init is not None:
            blk["ls1"] = {"gamma": np.asarray(state[pre + "ls1.gamma"])}
            blk["ls2"] = {"gamma": np.asarray(state[pre + "ls2.gamma"])}
        p[f"block{i}"] = blk

    p["norm"] = {
        "scale": np.asarray(state["norm.weight"]),
        "bias": np.asarray(state["norm.bias"]),
    }
    return p


def _conv_k(w: np.ndarray) -> np.ndarray:
    """torch Conv2d weight (out, in, kh, kw) -> flax kernel (kh, kw, in, out)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _deconv_k(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d weight (in, out, kh, kw) -> flax ConvTranspose
    kernel (kh, kw, in, out) with spatial flip (flax's default
    transpose_kernel=False convention; verified numerically vs torch)."""
    k = np.transpose(np.asarray(w), (2, 3, 0, 1))
    return np.ascontiguousarray(k[::-1, ::-1])


def _gn(state: dict, pre: str) -> dict:
    return {"scale": np.asarray(state[pre + "weight"]),
            "bias": np.asarray(state[pre + "bias"])}


def _cv(state: dict, pre: str) -> dict:
    return {"kernel": _conv_k(state[pre + "weight"]),
            "bias": np.asarray(state[pre + "bias"])}


def _res_block(state: dict, pre: str) -> dict:
    """Reference ResidualConvBlock (`moge_model.py:23-58`): layers Sequential
    [GroupNorm, act, Conv3, GroupNorm, act, Conv3] + optional 1x1 skip."""
    blk = {
        "norm1": _gn(state, pre + "layers.0."),
        "conv1": _cv(state, pre + "layers.2."),
        "norm2": _gn(state, pre + "layers.3."),
        "conv2": _cv(state, pre + "layers.5."),
    }
    if pre + "skip_connection.weight" in state:
        blk["skip"] = _cv(state, pre + "skip_connection.")
    return blk


def convert_moge_head(state: dict, cfg) -> dict:
    """Reference MoGe `Head` state dict -> Flax params for
    `moge.MoGeCheckpointHead` (torch names from `moge_model.py:60-108`:
    projects / upsample_blocks.{i}.[0.0 deconv, 0.1 conv, 1+r res] /
    output_block.{j}.[0 conv_in, 1+r res, conv_out])."""
    p: dict = {}
    n_levels = len(cfg.backbone.out_indices)
    for i in range(n_levels):
        p[f"project{i}"] = _cv(state, f"head.projects.{i}.")
    for i in range(len(cfg.dim_upsample)):
        pre = f"head.upsample_blocks.{i}."
        p[f"up{i}_deconv"] = {
            "kernel": _deconv_k(state[pre + "0.0.weight"]),
            "bias": np.asarray(state[pre + "0.0.bias"]),
        }
        p[f"up{i}_conv"] = _cv(state, pre + "0.1.")
        for r in range(cfg.num_res_blocks):
            p[f"up{i}_res{r}"] = _res_block(state, pre + f"{1 + r}.")
    n_out = 2 if (cfg.output_mask and cfg.split_head) else 1
    for j in range(n_out):
        # split_head=True -> output_block is a ModuleList (indexed names);
        # otherwise a single Sequential (no index segment).
        pre = f"head.output_block.{j}." if n_out > 1 else "head.output_block."
        p[f"out{j}_conv_in"] = _cv(state, pre + "0.")
        for r in range(cfg.last_res_blocks):
            p[f"out{j}_res{r}"] = _res_block(state, pre + f"{1 + r}.")
        p[f"out{j}_conv_out"] = _cv(state, pre + f"{cfg.last_res_blocks + 2}.")
    return p


def convert_moge_checkpoint(state: dict, cfg, grid_hw: tuple[int, int]) -> dict:
    """Full released-MoGe checkpoint (backbone.* + head.*) -> Flax params
    for `moge.MoGeModel` with `head_style='reference'`."""
    backbone_sd = {k[len("backbone."):]: v for k, v in state.items()
                   if k.startswith("backbone.")}
    return {
        "backbone": convert_dinov2_vit(backbone_sd, cfg.backbone, grid_hw),
        "head": convert_moge_head(state, cfg),
    }


def _sub(state: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _conv_nb(state: dict, key: str) -> dict:
    return {"kernel": _conv_k(state[key + ".weight"])}


def _proj_upsample(state: dict, pre: str, n_up: int) -> dict:
    """Reference `_create_project_upsample_block` (encoder.py:60-93):
    Sequential[1x1 conv, n_up x ConvTranspose], all bias-free."""
    p = {"proj": _conv_nb(state, pre + ".0")}
    for i in range(n_up):
        p[f"deconv{i}"] = {"kernel": _deconv_k(state[f"{pre}.{i + 1}.weight"])}
    return p


def _residual_unit(state: dict, pre: str) -> dict:
    """decoder.py:182-199 — residual Sequential[ReLU, conv, ReLU, conv]."""
    return {"conv1": _cv(state, pre + ".residual.1."),
            "conv2": _cv(state, pre + ".residual.3.")}


def convert_depth_pro(state: dict, cfg) -> dict:
    """Released DepthPro checkpoint (`depth_pro.pt`) -> Flax params for
    `depth_pro.DepthPro35(cfg)`.

    Torch names from `network/{encoder,decoder,fov}.py` + `depth_pro.py`;
    the three backbones are timm DINOv2 ViTs (resized to patch16/384) and
    go through `convert_dinov2_vit`.
    """
    gh = cfg.patch_res // cfg.patch_encoder.patch_size
    p: dict = {
        "patch_encoder": convert_dinov2_vit(
            _sub(state, "encoder.patch_encoder."), cfg.patch_encoder, (gh, gh)),
        "image_encoder": convert_dinov2_vit(
            _sub(state, "encoder.image_encoder."), cfg.image_encoder, (gh, gh)),
        "upsample_latent0": _proj_upsample(state, "encoder.upsample_latent0", 3),
        "upsample_latent1": _proj_upsample(state, "encoder.upsample_latent1", 2),
        "upsample0": _proj_upsample(state, "encoder.upsample0", 1),
        "upsample1": _proj_upsample(state, "encoder.upsample1", 1),
        "upsample2": _proj_upsample(state, "encoder.upsample2", 1),
        "upsample_lowres": {
            "kernel": _deconv_k(state["encoder.upsample_lowres.weight"]),
            "bias": np.asarray(state["encoder.upsample_lowres.bias"]),
        },
        "fuse_lowres": _cv(state, "encoder.fuse_lowres."),
        "head_c1": _cv(state, "head.0."),
        "head_deconv": {
            "kernel": _deconv_k(state["head.1.weight"]),
            "bias": np.asarray(state["head.1.bias"]),
        },
        "head_c2": _cv(state, "head.2."),
        "head_c3": _cv(state, "head.4."),
    }
    n_levels = 5  # [latent0, latent1, f0, f1, global]
    for i in range(n_levels):
        pre = f"decoder.fusions.{i}"
        blk: dict = {"res2": _residual_unit(state, pre + ".resnet2"),
                     "out_conv": _cv(state, pre + ".out_conv.")}
        if i != n_levels - 1:
            # the top (lowest-res) fusion is called without a skip input, so
            # its resnet1 params are unused in torch and absent in flax
            blk["res1"] = _residual_unit(state, pre + ".resnet1")
        if i != 0:
            blk["deconv"] = {"kernel": _deconv_k(state[pre + ".deconv.weight"])}
        p[f"dec_fusion{i}"] = blk
        if i > 0:  # convs.0 is Identity when dims match (decoder.py:42-45)
            p[f"dec_conv{i}"] = _conv_nb(state, f"decoder.convs.{i}")
    if cfg.fov_encoder is not None:
        p["fov_encoder"] = convert_dinov2_vit(
            _sub(state, "fov.encoder.0."), cfg.fov_encoder, (gh, gh))
        p["fov_enc_linear"] = {"kernel": _t(state["fov.encoder.1.weight"]),
                               "bias": np.asarray(state["fov.encoder.1.bias"])}
        p["fov_down"] = _cv(state, "fov.downsample.0.")
        p["fov_h0"] = _cv(state, "fov.head.0.")
        p["fov_h1"] = _cv(state, "fov.head.2.")
        p["fov_h2"] = _cv(state, "fov.head.4.")
    return p


def convert_mast3r_head(state: dict, cfg, prefix: str = "downstream_head1.") -> dict:
    """MASt3R `Cat_MLP_LocalFeatures_DPT_Pts3d` state dict -> Flax params for
    `matcher.CatMLPDPTHead`.

    Torch names from `catmlp_dpt_head.py` + croco `dpt_block.py`. The DPT
    adapter registers its resamplers under both `act_postprocess.{i}.{j}`
    and `act_{i+1}_postprocess.{j}` (aliased modules); either is accepted.
    """
    def key(*cands):
        for c in cands:
            if prefix + c in state:
                return state[prefix + c]
        raise KeyError(f"none of {cands} under {prefix}")

    def act(i, j):
        return (f"dpt.act_postprocess.{i}.{j}.", f"dpt.act_{i + 1}_postprocess.{j}.")

    def cv(cands):
        return {"kernel": _conv_k(key(*[c + "weight" for c in cands])),
                "bias": np.asarray(key(*[c + "bias" for c in cands]))}

    def dcv(cands):
        return {"kernel": _deconv_k(key(*[c + "weight" for c in cands])),
                "bias": np.asarray(key(*[c + "bias" for c in cands]))}

    p: dict = {
        "act0_proj": cv(act(0, 0)), "act0_deconv": dcv(act(0, 1)),
        "act1_proj": cv(act(1, 0)), "act1_deconv": dcv(act(1, 1)),
        "act2_proj": cv(act(2, 0)),
        "act3_proj": cv(act(3, 0)), "act3_conv": cv(act(3, 1)),
        "head_c1": cv(("dpt.head.0.",)),
        "head_c2": cv(("dpt.head.2.",)),
        "head_c3": cv(("dpt.head.4.",)),
        "mlp_fc1": {"kernel": _t(key("head_local_features.fc1.weight")),
                    "bias": np.asarray(key("head_local_features.fc1.bias"))},
        "mlp_fc2": {"kernel": _t(key("head_local_features.fc2.weight")),
                    "bias": np.asarray(key("head_local_features.fc2.bias"))},
    }
    for i in range(4):
        p[f"rn{i}"] = {"kernel": _conv_k(key(
            f"dpt.scratch.layer{i + 1}_rn.weight", f"dpt.scratch.layer_rn.{i}.weight"))}
    for k in range(1, 5):
        pre = f"dpt.scratch.refinenet{k}."
        blk: dict = {
            "res2": {"conv1": cv((pre + "resConfUnit2.conv1.",)),
                     "conv2": cv((pre + "resConfUnit2.conv2.",))},
            "out_conv": cv((pre + "out_conv.",)),
        }
        if k != 4:  # refinenet4 is called without a skip; its res1 is unused
            blk["res1"] = {"conv1": cv((pre + "resConfUnit1.conv1.",)),
                           "conv2": cv((pre + "resConfUnit1.conv2.",))}
        p[f"refine{k}"] = blk
    return p


def _ln(state: dict, pre: str) -> dict:
    return {"scale": np.asarray(state[pre + "weight"]),
            "bias": np.asarray(state[pre + "bias"])}


def _linear(state: dict, pre: str) -> dict:
    return {"kernel": _t(state[pre + "weight"]),
            "bias": np.asarray(state[pre + "bias"])}


def convert_mast3r(state: dict, cfg) -> dict:
    """Full MASt3R/DUSt3R checkpoint -> Flax params for
    `matcher.TwoViewMatcher(MatcherConfig.mast3r_vitl())`.

    Torch names from croco `croco.py`/`blocks.py` + dust3r `model.py`:
    enc_blocks (fused qkv), decoder_embed, dec_blocks/dec_blocks2
    (dec_blocks2 falls back to dec_blocks when the checkpoint shares
    decoders — model.py:93-96 does the same), dec_norm, downstream heads.
    """
    p: dict = {}

    # ---- encoder (CroCo ViT, RoPE -> no pos_embed/cls to map)
    enc: dict = {
        "patch_embed": {"kernel": _conv_k(state["patch_embed.proj.weight"]),
                        "bias": np.asarray(state["patch_embed.proj.bias"])},
        "norm": _ln(state, "enc_norm."),
    }
    for i in range(cfg.encoder.depth):
        pre = f"enc_blocks.{i}."
        enc[f"block{i}"] = {
            "norm1": _ln(state, pre + "norm1."),
            "norm2": _ln(state, pre + "norm2."),
            "attn": {"qkv": _linear(state, pre + "attn.qkv."),
                     "proj": _linear(state, pre + "attn.proj.")},
            "mlp": {"fc1": _linear(state, pre + "mlp.fc1."),
                    "fc2": _linear(state, pre + "mlp.fc2.")},
        }
    p["encoder"] = enc

    p["dec_embed"] = _linear(state, "decoder_embed.")
    p["dec_norm"] = _ln(state, "dec_norm.")

    def dec_block(pre: str) -> dict:
        d = cfg.dec_width
        qkv_w = np.asarray(state[pre + "attn.qkv.weight"])  # (3D, D)
        qkv_b = np.asarray(state[pre + "attn.qkv.bias"])
        blk = {
            "norm1": _ln(state, pre + "norm1."),
            "norm2": _ln(state, pre + "norm2."),
            "norm3": _ln(state, pre + "norm3."),
            "norm_other": _ln(state, pre + "norm_y."),
            "self_proj": _linear(state, pre + "attn.proj."),
            "cross_q": _linear(state, pre + "cross_attn.projq."),
            "cross_k": _linear(state, pre + "cross_attn.projk."),
            "cross_v": _linear(state, pre + "cross_attn.projv."),
            "cross_proj": _linear(state, pre + "cross_attn.proj."),
            "mlp": {"fc1": _linear(state, pre + "mlp.fc1."),
                    "fc2": _linear(state, pre + "mlp.fc2.")},
        }
        for j, nm in enumerate(("self_q", "self_k", "self_v")):
            blk[nm] = {"kernel": _t(qkv_w[j * d:(j + 1) * d]),
                       "bias": qkv_b[j * d:(j + 1) * d]}
        return blk

    has_dec2 = any(k.startswith("dec_blocks2.") for k in state)
    for i in range(cfg.dec_depth):
        p[f"dec0_block{i}"] = dec_block(f"dec_blocks.{i}.")
        pre2 = f"dec_blocks2.{i}." if has_dec2 else f"dec_blocks.{i}."
        p[f"dec1_block{i}"] = dec_block(pre2)

    p["head0"] = convert_mast3r_head(state, cfg, prefix="downstream_head1.")
    p["head1"] = convert_mast3r_head(state, cfg, prefix="downstream_head2.")
    return p


def load_torch_checkpoint(path: str) -> dict:
    """Load a torch checkpoint into numpy arrays (CPU, no grad state)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}
