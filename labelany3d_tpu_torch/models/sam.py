"""Segment-Anything promptable instance segmentation: the wild-mode segmenter.

Counterpart of `labelany3d_tpu/models/sam.py`, in the reference's
EntityV2/CropFormer role (`src/model_wrappers.py:482-543`): a ViTDet image
encoder (windowed blocks, and global blocks with a decomposed relative
position bias), a Fourier point encoding, and a two-way-transformer mask
decoder, driven by a point grid to give class-agnostic instance masks. The
modules carry the JAX package's Flax names, so `convert_sam` (the JAX
converter, copied) renames a `transformers` `SamModel` state dict
(facebook/sam-vit-base/large/huge) into a tree `flax_to_state_dict` loads.

The encoder's activations are `cfg.dtype` (bf16 by default) with float32
LayerNorms; the relative-position bias is built in float32 and cast to the
activation dtype, as in the JAX package. The decoder runs in float32. All
attention is plain PyTorch (`layers.dense_attention`, float32 softmax), as
the JAX package leaves it to XLA. Images are NHWC at the interface.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import (
    Conv,
    ConvTranspose,
    Dense,
    LayerNorm32,
    dense_attention,
    nchw,
    nhwc,
    resize,
)
from labelany3d_tpu_torch.utils.device import resolve_device
from labelany3d_tpu_torch.utils.precision import full_f32

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SamConfig:
    # vision encoder (ViTDet)
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    image_size: int = 1024
    patch_size: int = 16
    window_size: int = 14
    global_attn_indexes: Sequence[int] = (2, 5, 8, 11)
    out_channels: int = 256
    mlp_ratio: float = 4.0
    # prompt encoder / mask decoder
    prompt_dim: int = 256
    num_pos_feats: int = 128
    mask_input_channels: int = 16
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    dtype: Any = torch.bfloat16

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @staticmethod
    def vit_base(**kw) -> "SamConfig":
        """facebook/sam-vit-base."""
        return SamConfig(**kw)

    @staticmethod
    def vit_large(**kw) -> "SamConfig":
        return SamConfig(width=1024, depth=24, num_heads=16,
                         global_attn_indexes=(5, 11, 17, 23), **kw)

    @staticmethod
    def vit_huge(**kw) -> "SamConfig":
        return SamConfig(width=1280, depth=32, num_heads=16,
                         global_attn_indexes=(7, 15, 23, 31), **kw)

    @staticmethod
    def tiny_test(**kw) -> "SamConfig":
        return SamConfig(
            width=32, depth=2, num_heads=2, image_size=64, patch_size=8,
            window_size=4, global_attn_indexes=(1,), out_channels=16,
            prompt_dim=16, num_pos_feats=8, mask_input_channels=4,
            decoder_heads=2, decoder_mlp_dim=32, iou_head_hidden_dim=16,
            **kw,
        )


# ------------------------------------------------------------ vision encoder


def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Per-axis relative-position table lookup, (q, k, C). A table of
    another length is first resized along its length as
    `jax.image.resize(..., 'linear')` does (half-pixel centres, antialiased
    when it shrinks); the index table is static."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        view = rel_pos.float().t()[None, :, None, :]  # (1, C, 1, L)
        rel_pos = resize(view, (1, max_rel_dist), method="bilinear")[0, :, 0].t()
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[torch.as_tensor(rel.astype(np.int64), device=rel_pos.device)]


class _VisionAttention(nn.Module):
    """MHA with the decomposed 2D relative position bias (ViTDet) over a
    `size` x `size` token grid."""

    def __init__(self, cfg: SamConfig, size: int):
        super().__init__()
        self.heads = cfg.num_heads
        head_dim = cfg.width // cfg.num_heads
        self.qkv = Dense(cfg.width, 3 * cfg.width, cfg.dtype)
        self.proj = Dense(cfg.width, cfg.width, cfg.dtype)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C) token grid
        b, h, w, c = x.shape
        n, hd = self.heads, c // self.heads
        q, k, v = self.qkv(x).reshape(b, h * w, 3, n, hd).unbind(2)  # (B, N, h, d)
        rh = _get_rel_pos(h, h, self.rel_pos_h).float()  # (h, h, d)
        rw = _get_rel_pos(w, w, self.rel_pos_w).float()  # (w, w, d)
        qg = q.reshape(b, h, w, n, hd).float()
        with full_f32():
            bias_h = torch.einsum("bhwnc,hkc->bnhwk", qg, rh)
            bias_w = torch.einsum("bhwnc,wkc->bnhwk", qg, rw)
        # (B, heads, h, w, kh, kw) -> (B, heads, N, N), in f32, then cast.
        bias = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, n, h * w, h * w)
        out = dense_attention(q, k, v, bias=bias.to(q.dtype))
        return self.proj(out.reshape(b, h, w, c))


class _VisionBlock(nn.Module):
    def __init__(self, cfg: SamConfig, window: int):  # window 0 = global
        super().__init__()
        self.window, self.dtype = window, cfg.dtype
        self.norm1 = LayerNorm32(cfg.width)
        self.attn = _VisionAttention(cfg, window or cfg.grid)
        self.norm2 = LayerNorm32(cfg.width)
        self.lin1 = Dense(cfg.width, int(cfg.width * cfg.mlp_ratio), cfg.dtype)
        self.lin2 = Dense(int(cfg.width * cfg.mlp_ratio), cfg.width, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        res = x
        x = self.norm1(x).to(self.dtype)
        b, h, w, c = x.shape
        ws = self.window
        if ws:
            ph, pw = (-h) % ws, (-w) % ws
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            x = (x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
                 .reshape(-1, ws, ws, c))
        x = self.attn(x)
        if ws:
            x = (x.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
                 .reshape(b, hp, wp, c))[:, :h, :w]
        x = res + x
        y = self.lin1(self.norm2(x).to(self.dtype))
        return x + self.lin2(F.gelu(y))


class SamVisionEncoder(nn.Module):
    """(B, S, S, 3) preprocessed pixels -> (B, g, g, out_channels)."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dtype
        self.patch_embed = Conv(3, cfg.width, cfg.patch_size, d, stride=cfg.patch_size,
                                padding=0)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.grid, cfg.grid, cfg.width))
        for i in range(cfg.depth):
            win = 0 if i in cfg.global_attn_indexes else cfg.window_size
            self.add_module(f"block{i}", _VisionBlock(cfg, win))
        self.neck_conv1 = Conv(cfg.width, cfg.out_channels, 1, d, padding=0, bias=False)
        self.neck_norm1 = LayerNorm32(cfg.out_channels)
        self.neck_conv2 = Conv(cfg.out_channels, cfg.out_channels, 3, d, padding=1, bias=False)
        self.neck_norm2 = LayerNorm32(cfg.out_channels)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        d = cfg.dtype
        x = nhwc(self.patch_embed(nchw(pixels.to(d))))
        pos = self.pos_embed
        if pos.shape[1:3] != x.shape[1:3]:
            pos = nhwc(resize(nchw(pos.float()), tuple(x.shape[1:3]), method="bicubic"))
        x = x + pos.to(d)
        for i in range(cfg.depth):
            x = getattr(self, f"block{i}")(x)
        # The neck: 1x1 conv + LN + 3x3 conv + LN over channels (HF's
        # channels_first SamLayerNorm on NCHW).
        x = self.neck_norm1(nhwc(self.neck_conv1(nchw(x))))
        x = self.neck_norm2(nhwc(self.neck_conv2(nchw(x.to(d)))))
        return x.to(d)


# --------------------------------------------------- prompts + mask decoder


class _FourierPE(nn.Module):
    """Random-Fourier point encoding shared by prompts and the image grid."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.zeros(2, num_pos_feats))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:  # (..., 2) in [0, 1]
        c = 2.0 * coords01.float() - 1.0
        with full_f32():
            c = (2.0 * np.pi) * (c @ self.positional_embedding.float())
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class _DownAttention(nn.Module):
    """Attention with internal-dim downsampling (SamAttention)."""

    def __init__(self, cfg: SamConfig, downsample: int):
        super().__init__()
        self.inner = cfg.prompt_dim // downsample
        self.heads = cfg.decoder_heads
        self.q_proj = Dense(cfg.prompt_dim, self.inner, _F32)
        self.k_proj = Dense(cfg.prompt_dim, self.inner, _F32)
        self.v_proj = Dense(cfg.prompt_dim, self.inner, _F32)
        self.out_proj = Dense(self.inner, cfg.prompt_dim, _F32)

    def forward(self, q, k, v):  # (B, P, T, C) each
        def split(t):
            b, p, n, _ = t.shape
            return t.reshape(b * p, n, self.heads, self.inner // self.heads)

        out = dense_attention(split(self.q_proj(q)), split(self.k_proj(k)),
                              split(self.v_proj(v)))
        return self.out_proj(out.reshape(q.shape[:3] + (self.inner,)))


class _TwoWayBlock(nn.Module):
    def __init__(self, cfg: SamConfig, skip_first_pe: bool):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        c, ds = cfg.prompt_dim, cfg.attention_downsample_rate
        self.self_attn = _DownAttention(cfg, 1)
        self.cross_attn_t2i = _DownAttention(cfg, ds)
        self.cross_attn_i2t = _DownAttention(cfg, ds)
        for i in range(1, 5):
            self.add_module(f"norm{i}", LayerNorm32(c))
        self.mlp_lin1 = Dense(c, cfg.decoder_mlp_dim, _F32)
        self.mlp_lin2 = Dense(cfg.decoder_mlp_dim, c, _F32)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_t2i(q, k, keys))
        m = self.mlp_lin2(F.relu(self.mlp_lin1(queries)))
        queries = self.norm3(queries + m)

        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_i2t(k, q, queries))
        return queries, keys


class _FeedForward(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out: int, layers: int):
        super().__init__()
        self.n_mid = layers - 2
        self.proj_in = Dense(in_dim, hidden, _F32)
        for i in range(self.n_mid):
            self.add_module(f"layer{i}", Dense(hidden, hidden, _F32))
        self.proj_out = Dense(hidden, out, _F32)

    def forward(self, x):
        x = F.relu(self.proj_in(x))
        for i in range(self.n_mid):
            x = F.relu(getattr(self, f"layer{i}")(x))
        return self.proj_out(x)


class SamMaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        c, pd = cfg.out_channels, cfg.prompt_dim
        self.num_mask_tokens = cfg.num_multimask_outputs + 1
        self.iou_token = nn.Parameter(torch.zeros(1, pd))
        self.mask_tokens = nn.Parameter(torch.zeros(self.num_mask_tokens, pd))
        for i in range(cfg.decoder_depth):
            self.add_module(f"layer{i}", _TwoWayBlock(cfg, skip_first_pe=i == 0))
        self.final_attn = _DownAttention(cfg, cfg.attention_downsample_rate)
        self.norm_final = LayerNorm32(pd)
        self.upscale_conv1 = ConvTranspose(c, c // 4, 2, _F32)
        self.upscale_norm = LayerNorm32(c // 4)
        self.upscale_conv2 = ConvTranspose(c // 4, c // 8, 2, _F32)
        for i in range(self.num_mask_tokens):
            self.add_module(f"hyper{i}", _FeedForward(pd, pd, c // 8, 3))
        self.iou_head = _FeedForward(pd, cfg.iou_head_hidden_dim, self.num_mask_tokens,
                                     cfg.iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse_embeddings, dense_embeddings,
                multimask_output: bool = True):
        """image_embeddings (B, g, g, C); image_pe (1, g, g, C); sparse
        (B, P, T, C); dense (B, g, g, C) -> mask logits (B, P, M, 4g, 4g)
        and IoU predictions (B, P, M)."""
        b, gh, gw, c = image_embeddings.shape
        p = sparse_embeddings.shape[1]
        out_tokens = torch.cat([self.iou_token, self.mask_tokens]).float()
        out_tokens = out_tokens.expand((b, p) + out_tokens.shape)
        tokens = torch.cat([out_tokens, sparse_embeddings.float()], dim=2)

        src = image_embeddings.float() + dense_embeddings.float()
        keys = src.reshape(b, 1, gh * gw, c).expand(b, p, gh * gw, c)
        key_pe = image_pe.float().reshape(1, 1, gh * gw, c).expand(b, p, gh * gw, c)

        queries = tokens
        for i in range(self.cfg.decoder_depth):
            queries, keys = getattr(self, f"layer{i}")(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = self.norm_final(queries + self.final_attn(q, k, keys))

        iou_out = queries[:, :, 0]
        mask_out = queries[:, :, 1:1 + self.num_mask_tokens]

        up = nchw(keys.reshape(b * p, gh, gw, c))
        up = F.gelu(self.upscale_norm(nhwc(self.upscale_conv1(up))))
        up = nhwc(F.gelu(self.upscale_conv2(nchw(up))))  # (B*P, 4g, 4g, c/8)

        hyper = torch.stack([getattr(self, f"hyper{i}")(mask_out[:, :, i])
                             for i in range(self.num_mask_tokens)], dim=2)  # (B, P, M, c/8)
        up = up.reshape(b, p, 16 * gh * gw, c // 8)
        with full_f32():
            masks = torch.einsum("bpmc,bpnc->bpmn", hyper, up)
        masks = masks.reshape(b, p, self.num_mask_tokens, 4 * gh, 4 * gw)
        iou_pred = self.iou_head(iou_out)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, :, sl], iou_pred[:, :, sl]


class SamCore(nn.Module):
    """Pixels + point prompts -> mask logits.

    input_points (B, P, N, 2) in pixel coordinates of the model input frame;
    input_labels (B, P, N): 1 foreground, 0 background, -1 not-a-point,
    -10 pad."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = SamVisionEncoder(cfg)
        self.shared_pe = _FourierPE(cfg.num_pos_feats)
        self.decoder = SamMaskDecoder(cfg)
        self.point_embed = nn.Parameter(torch.zeros(4, cfg.prompt_dim))
        self.not_a_point = nn.Parameter(torch.zeros(cfg.prompt_dim))
        self.no_mask_embed = nn.Parameter(torch.zeros(cfg.prompt_dim))

    def _image_pe(self, g: int, device) -> torch.Tensor:
        ar = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) / g
        yy, xx = torch.meshgrid(ar, ar, indexing="ij")
        return self.shared_pe(torch.stack([xx, yy], dim=-1))[None]  # (1, g, g, C)

    def _embed_points(self, points, labels):
        """The prompts, padded with one not-a-point each (no box prompt)."""
        pts = points.float() + 0.5
        pts = torch.cat([pts, pts.new_zeros(pts.shape[:2] + (1, 2))], dim=2)
        labels = torch.cat([labels, -labels.new_ones(labels.shape[:2] + (1,))], dim=2)
        emb = self.shared_pe(pts / self.cfg.image_size)
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point.float(), emb)
        emb = torch.where(lab == -10, torch.zeros_like(emb), emb)
        emb = torch.where(lab == 0, emb + self.point_embed[0].float(), emb)
        return torch.where(lab == 1, emb + self.point_embed[1].float(), emb)

    def decode(self, image_embeddings, input_points, input_labels,
               multimask_output: bool = True):
        """The decoder over precomputed image embeddings (the encoder runs
        once per image; prompts batch over P)."""
        sparse = self._embed_points(input_points, input_labels)
        dense = self.no_mask_embed.float().reshape(1, 1, 1, -1).expand(image_embeddings.shape)
        pe = self._image_pe(image_embeddings.shape[1], image_embeddings.device)
        return self.decoder(image_embeddings, pe, sparse, dense,
                            multimask_output=multimask_output)

    def forward(self, pixels, input_points, input_labels, multimask_output: bool = True):
        return self.decode(self.vision(pixels), input_points, input_labels,
                           multimask_output=multimask_output)


@torch.no_grad()
def init_sam_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Flax's initialisers for the SAM modules: `init_params_`, then zero
    position embeddings and relative-position tables and unit normals for
    the tokens, point embeddings and the Fourier matrix."""
    from labelany3d_tpu_torch.models.weights import init_params_

    init_params_(model, gen)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("pos_embed", "rel_pos_h", "rel_pos_w"):
            p.zero_()
        elif leaf in ("iou_token", "mask_tokens", "point_embed", "not_a_point",
                      "no_mask_embed", "positional_embedding"):
            p.normal_(0.0, 1.0, generator=gen)
    return model


# --------------------------------------------------------------- converter


def _lin(state, pre):
    d = {"kernel": np.asarray(state[pre + ".weight"]).T}
    if pre + ".bias" in state:
        d["bias"] = np.asarray(state[pre + ".bias"])
    return d


def _ln(state, pre):
    return {"scale": np.asarray(state[pre + ".weight"]),
            "bias": np.asarray(state[pre + ".bias"])}


def _conv_k(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _deconv_k(w):
    k = np.transpose(np.asarray(w), (2, 3, 0, 1))
    return np.ascontiguousarray(k[::-1, ::-1])


def _down_attn(state, pre):
    return {n: _lin(state, f"{pre}.{n}") for n in ("q_proj", "k_proj", "v_proj", "out_proj")}


def _feed_forward(state, pre, num_layers):
    d = {"proj_in": _lin(state, pre + ".proj_in"),
         "proj_out": _lin(state, pre + ".proj_out")}
    for i in range(num_layers - 2):
        d[f"layer{i}"] = _lin(state, pre + f".layers.{i}")
    return d


def convert_sam(state: dict, cfg: SamConfig) -> dict:
    """transformers SamModel state_dict -> SamCore's Flax-layout tree."""
    num_mask_tokens = cfg.num_multimask_outputs + 1
    ve = "vision_encoder"
    vision = {
        "patch_embed": {"kernel": _conv_k(state[f"{ve}.patch_embed.projection.weight"]),
                        "bias": np.asarray(state[f"{ve}.patch_embed.projection.bias"])},
        "pos_embed": np.asarray(state[f"{ve}.pos_embed"]),
        "neck_conv1": {"kernel": _conv_k(state[f"{ve}.neck.conv1.weight"])},
        "neck_norm1": _ln(state, f"{ve}.neck.layer_norm1"),
        "neck_conv2": {"kernel": _conv_k(state[f"{ve}.neck.conv2.weight"])},
        "neck_norm2": _ln(state, f"{ve}.neck.layer_norm2"),
    }
    for i in range(cfg.depth):
        pre = f"{ve}.layers.{i}"
        vision[f"block{i}"] = {
            "norm1": _ln(state, pre + ".layer_norm1"),
            "norm2": _ln(state, pre + ".layer_norm2"),
            "attn": {"qkv": _lin(state, pre + ".attn.qkv"),
                     "proj": _lin(state, pre + ".attn.proj"),
                     "rel_pos_h": np.asarray(state[pre + ".attn.rel_pos_h"]),
                     "rel_pos_w": np.asarray(state[pre + ".attn.rel_pos_w"])},
            "lin1": _lin(state, pre + ".mlp.lin1"),
            "lin2": _lin(state, pre + ".mlp.lin2"),
        }

    def two_way(pre):
        return {
            "self_attn": _down_attn(state, pre + ".self_attn"),
            "cross_attn_t2i": _down_attn(state, pre + ".cross_attn_token_to_image"),
            "cross_attn_i2t": _down_attn(state, pre + ".cross_attn_image_to_token"),
            **{f"norm{j}": _ln(state, f"{pre}.layer_norm{j}") for j in range(1, 5)},
            "mlp_lin1": _lin(state, pre + ".mlp.lin1"),
            "mlp_lin2": _lin(state, pre + ".mlp.lin2"),
        }

    md = "mask_decoder"
    decoder = {
        "iou_token": np.asarray(state[f"{md}.iou_token.weight"]),
        "mask_tokens": np.asarray(state[f"{md}.mask_tokens.weight"]),
        "final_attn": _down_attn(state, f"{md}.transformer.final_attn_token_to_image"),
        "norm_final": _ln(state, f"{md}.transformer.layer_norm_final_attn"),
        "upscale_conv1": {"kernel": _deconv_k(state[f"{md}.upscale_conv1.weight"]),
                          "bias": np.asarray(state[f"{md}.upscale_conv1.bias"])},
        "upscale_conv2": {"kernel": _deconv_k(state[f"{md}.upscale_conv2.weight"]),
                          "bias": np.asarray(state[f"{md}.upscale_conv2.bias"])},
        "upscale_norm": _ln(state, f"{md}.upscale_layer_norm"),
        "iou_head": _feed_forward(state, f"{md}.iou_prediction_head", cfg.iou_head_depth),
    }
    for i in range(cfg.decoder_depth):
        decoder[f"layer{i}"] = two_way(f"{md}.transformer.layers.{i}")
    for i in range(num_mask_tokens):
        decoder[f"hyper{i}"] = _feed_forward(state, f"{md}.output_hypernetworks_mlps.{i}", 3)

    pe = "prompt_encoder"
    return {
        "vision": vision,
        "decoder": decoder,
        "shared_pe": {"positional_embedding": np.asarray(
            state["shared_image_embedding.positional_embedding"])},
        "point_embed": np.stack([np.asarray(state[f"{pe}.point_embed.{i}.weight"])[0]
                                 for i in range(4)]),
        "not_a_point": np.asarray(state[f"{pe}.not_a_point_embed.weight"])[0],
        "no_mask_embed": np.asarray(state[f"{pe}.no_mask_embed.weight"])[0],
    }


# ------------------------------------------------- automatic mask generation

SAM_IMAGE_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_IMAGE_STD = np.array([58.395, 57.12, 57.375], np.float32)


class SamAutoSegmentation:
    """Class-agnostic instance masks from a point grid (the EntityV2 role).

    One encoder pass an image on `device`; the grid's prompts go through the
    decoder in chunks of `prompt_chunk` (the last padded); then, on the
    host as in the JAX package, the best of the three masks by predicted
    IoU, the stability score, the three thresholds, greedy NMS on the
    4x-strided masks, and a NEAREST resize back to the image.

    `points_per_side` sets the cost: 16 (256 prompts) recovers most small
    objects, 8 (64 prompts, one decoder call) is the cheap setting. `params`
    is a Flax-layout tree (from `convert_sam`); without it the weights are
    random from a generator seeded with `seed`, with a one-shot warning.
    """

    def __init__(self, cfg: SamConfig | None = None, params=None,
                 points_per_side: int = 16, pred_iou_thresh: float = 0.7,
                 stability_offset: float = 1.0, stability_thresh: float = 0.95,
                 nms_iou: float = 0.7, min_area_frac: float = 0.0005, seed: int = 0,
                 prompt_chunk: int = 64, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg or SamConfig.vit_base()
        self.params = params
        self.points_per_side = points_per_side
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_offset = stability_offset
        self.stability_thresh = stability_thresh
        self.nms_iou = nms_iou
        self.min_area_frac = min_area_frac
        self.prompt_chunk = prompt_chunk
        self.seed = seed
        self.model: SamCore | None = None
        self._lock = threading.Lock()

    def _ensure(self) -> None:
        # The stages call the provider from their prefetch threads.
        with self._lock:
            if self.model is not None:
                return
            from labelany3d_tpu_torch.models.weights import build_module

            if self.params is None:
                from labelany3d_tpu_torch.utils.logging import warn_once

                warn_once("sam_random",
                          "SAM segmenter runs with random-initialized weights (no converted "
                          "checkpoint): wild-mode instances are not meaningful")
            self.model = build_module(lambda: SamCore(self.cfg), self.device, self.params,
                                      self.seed, init=init_sam_)
            self.params = None  # the model holds them now

    def preprocess(self, image: np.ndarray) -> torch.Tensor:
        """uint8 RGB (H, W, 3) -> (1, S, S, 3) normalised pixels on `device`:
        Pillow's BILINEAR resize to the model size, then SAM's mean/std."""
        from PIL import Image

        s = self.cfg.image_size
        proc = np.asarray(Image.fromarray(image).resize((s, s), Image.BILINEAR))
        x = (proc.astype(np.float32) - SAM_IMAGE_MEAN) / SAM_IMAGE_STD
        return torch.as_tensor(x, device=self.device)[None]

    @torch.inference_mode()
    def decode_grid(self, image: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """uint8 RGB (H, W, 3) -> the grid's mask logits (P, 3, 4g, 4g) and
        IoU predictions (P, 3), float32 on the host."""
        self._ensure()
        s, g = self.cfg.image_size, self.points_per_side
        ar = (np.arange(g) + 0.5) / g * s
        xx, yy = np.meshgrid(ar, ar)
        pts = np.stack([xx.ravel(), yy.ravel()], axis=-1)  # (g*g, 2)
        emb = self.model.vision(self.preprocess(image))
        # Every chunk has the same (1, chunk, 1, 2) shape.
        chunk = min(self.prompt_chunk, g * g)
        pts_pad = np.concatenate([pts, np.zeros((-len(pts) % chunk, 2))]).astype(np.float32)
        labs = torch.ones((1, chunk, 1), dtype=torch.int32, device=self.device)
        mask_chunks, iou_chunks = [], []
        for c0 in range(0, len(pts_pad), chunk):
            cp = torch.as_tensor(pts_pad[None, c0:c0 + chunk, None, :], device=self.device)
            m, i = self.model.decode(emb, cp, labs)
            mask_chunks.append(m[0].float().cpu().numpy())
            iou_chunks.append(i[0].float().cpu().numpy())
        return np.concatenate(mask_chunks)[:len(pts)], np.concatenate(iou_chunks)[:len(pts)]

    def select(self, masks: np.ndarray, iou: np.ndarray, hw: tuple[int, int]) -> list:
        """The grid's logits and IoU predictions -> boolean (H, W) masks:
        best of three by IoU, the thresholds, greedy NMS, NEAREST resize."""
        from PIL import Image

        h, w = hw
        best = iou.argmax(axis=1)
        sel_masks = masks[np.arange(masks.shape[0]), best]
        sel_iou = iou[np.arange(iou.shape[0]), best]
        # Stability score: how little the mask area changes when the logit
        # threshold moves by +/- stability_offset around 0.
        hi = (sel_masks > self.stability_offset).sum(axis=(-1, -2))
        lo = (sel_masks > -self.stability_offset).sum(axis=(-1, -2))
        stability = hi / np.maximum(lo, 1)

        min_area = self.min_area_frac * sel_masks.shape[-1] * sel_masks.shape[-2]
        bin_masks = sel_masks > 0.0
        areas = bin_masks.sum(axis=(-1, -2)).astype(np.float64)
        ok = ((sel_iou >= self.pred_iou_thresh) & (stability >= self.stability_thresh)
              & (areas >= min_area))
        cand = np.nonzero(ok)[0]
        cand = cand[np.argsort(-sel_iou[cand])]
        # Greedy NMS over a pairwise IoU matrix of the 4x-strided masks
        # (intersections from one float matmul).
        kept_idx: list[int] = []
        if len(cand):
            flat = bin_masks[cand][:, ::4, ::4].reshape(len(cand), -1).astype(np.float32)
            inter = flat @ flat.T
            ar = flat.sum(axis=1)
            iou_mat = inter / (ar[:, None] + ar[None, :] - inter + 1e-9)
            kept_pos: list[int] = []
            for j in range(len(cand)):
                if all(iou_mat[j, k] <= self.nms_iou for k in kept_pos):
                    kept_pos.append(j)
            kept_idx = [int(cand[j]) for j in kept_pos]
        return [np.asarray(Image.fromarray(bin_masks[i].astype(np.uint8) * 255)
                           .resize((w, h), Image.NEAREST)) > 127 for i in kept_idx]

    def segment(self, image: np.ndarray) -> list:
        """uint8 RGB (H, W, 3) -> list of boolean instance masks (H, W)."""
        return self.select(*self.decode_grid(image), image.shape[:2])
