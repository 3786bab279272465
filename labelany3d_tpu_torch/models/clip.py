"""CLIP text and vision encoders, HF-checkpoint compatible.

Counterpart of `labelany3d_tpu/models/clip.py`. The diffusion pipelines
condition on them: the amodal completion and InvSR on CLIP text
embeddings, Zero123 on CLIP vision image embeddings, the Hunyuan3D
multi-view diffusion on two vision towers (ViT-L/14 and ViT-bigG/14).
Module names follow
the Flax tree (`layer{i}.self_attn.q_proj`, `final_layer_norm`), so
`models/weights.py` carries parameters across; released `transformers`
state dicts go through `convert_clip_text` / `convert_clip_vision`.

Activations in the config's dtype with float32 LayerNorms; the attention
is plain PyTorch (`layers.dense_attention`: the JAX package leaves it to
XLA), causal for the text tower.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Conv, Dense, LayerNorm32, dense_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    max_len: int = 77
    eos_token_id: int = 49407
    projection_dim: int | None = None  # text_projection (similarity models)
    hidden_act: str = "quick_gelu"
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd15(**kw) -> "CLIPTextConfig":
        """openai/clip-vit-large-patch14 text tower: the SD 1.x /
        InstructPix2Pix / Zero123 conditioning encoder."""
        return CLIPTextConfig(**kw)

    @staticmethod
    def sd2(**kw) -> "CLIPTextConfig":
        """OpenCLIP ViT-H text tower (SD 2.x): gelu activation."""
        return CLIPTextConfig(width=1024, depth=23, num_heads=16, hidden_act="gelu", **kw)

    @staticmethod
    def tiny_test(**kw) -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=64, width=32, depth=2, num_heads=2, max_len=16,
                              eos_token_id=63, **kw)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    projection_dim: int | None = 768  # visual_projection -> image_embeds
    hidden_act: str = "quick_gelu"
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def vitl14(**kw) -> "CLIPVisionConfig":
        """openai/clip-vit-large-patch14 vision tower (Zero123's image
        conditioner at 224^2)."""
        return CLIPVisionConfig(**kw)

    @staticmethod
    def bigg14(**kw) -> "CLIPVisionConfig":
        """laion/CLIP-ViT-bigG-14 vision tower (the Hunyuan3D mvd_std
        pipeline's `vision_encoder_2`): exact-erf GELU, 1280-dim
        projection."""
        return CLIPVisionConfig(width=1664, depth=48, num_heads=16, mlp_ratio=8192 / 1664,
                                projection_dim=1280, hidden_act="gelu", **kw)

    @staticmethod
    def tiny_test(**kw) -> "CLIPVisionConfig":
        kw.setdefault("projection_dim", 16)
        return CLIPVisionConfig(image_size=32, patch_size=8, width=32, depth=2, num_heads=2,
                                **kw)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x)
    raise ValueError(f"Unknown hidden_act: {name}")


class _CLIPAttention(nn.Module):
    def __init__(self, width: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            Dense(width, width, dtype) for _ in range(4))

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        def heads(t):
            return t.reshape(*t.shape[:-1], self.num_heads, -1)

        out = dense_attention(heads(self.q_proj(x)), heads(self.k_proj(x)),
                              heads(self.v_proj(x)), causal=causal)
        return self.out_proj(out.reshape(x.shape[:-1] + (-1,)))


class _CLIPBlock(nn.Module):
    def __init__(self, width: int, num_heads: int, mlp_ratio: float, hidden_act: str,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.layer_norm1 = LayerNorm32(width, eps=1e-5)
        self.self_attn = _CLIPAttention(width, num_heads, dtype)
        self.layer_norm2 = LayerNorm32(width, eps=1e-5)
        self.fc1 = Dense(width, int(width * mlp_ratio), dtype)
        self.fc2 = Dense(int(width * mlp_ratio), width, dtype)
        self.act = _act(hidden_act)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x).to(self.dtype), causal)
        h = self.fc1(self.layer_norm2(x).to(self.dtype))
        return x + self.fc2(self.act(h))


def _add_blocks(tower: nn.Module, cfg) -> None:
    """The blocks as `layer{i}` children, the Flax tree's names."""
    for i in range(cfg.depth):
        tower.add_module(f"layer{i}", _CLIPBlock(cfg.width, cfg.num_heads, cfg.mlp_ratio,
                                                 cfg.hidden_act, cfg.dtype))


def _run_blocks(tower: nn.Module, x: torch.Tensor, causal: bool) -> torch.Tensor:
    for i in range(tower.cfg.depth):
        x = getattr(tower, f"layer{i}")(x, causal)
    return x


class CLIPTextEncoder(nn.Module):
    """Token ids (B, L) int -> dict:

      last_hidden  (B, L, D) final-layernormed sequence (the SD/IP2P
                   cross-attention conditioning)
      pooled       (B, D) hidden at the EOT position
      text_embeds  (B, P) pooled @ text_projection (when projection_dim)
    """

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.width))
        self.position_embedding = nn.Parameter(torch.zeros(cfg.max_len, cfg.width))
        _add_blocks(self, cfg)
        self.final_layer_norm = LayerNorm32(cfg.width, eps=1e-5)
        if cfg.projection_dim is not None:
            self.text_projection = Dense(cfg.width, cfg.projection_dim, cfg.dtype, bias=False)

    def forward(self, ids: torch.Tensor) -> dict:
        cfg = self.cfg
        x = (self.token_embedding[ids].to(cfg.dtype)
             + self.position_embedding[:ids.shape[-1]].to(cfg.dtype))
        x = _run_blocks(self, x, causal=True)
        x = self.final_layer_norm(x)
        # EOT pooling: the first occurrence of eos_token_id in each row (HF
        # CLIP); a row without one pools at its highest id (classic CLIP).
        is_eos = ids == cfg.eos_token_id
        eot = torch.where(is_eos.any(-1), is_eos.int().argmax(-1), ids.argmax(-1))
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        out = {"last_hidden": x.to(cfg.dtype), "pooled": pooled.to(cfg.dtype)}
        if cfg.projection_dim is not None:
            out["text_embeds"] = self.text_projection(pooled.to(cfg.dtype))
        return out


class CLIPVisionEncoder(nn.Module):
    """Images (B, H, W, 3), CLIP-normalized, -> dict:

      tokens        (B, 1+N, D) last hidden states (cls first)
      pooled        (B, D) post-layernormed class token
      image_embeds  (B, P) pooled @ visual_projection (when projection_dim)
    """

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.patch_embedding = Conv(3, cfg.width, p, cfg.dtype, stride=p, padding=0, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.position_embedding = nn.Parameter(
            torch.zeros(1 + (cfg.image_size // p) ** 2, cfg.width))
        self.pre_layernorm = LayerNorm32(cfg.width, eps=1e-5)
        _add_blocks(self, cfg)
        self.post_layernorm = LayerNorm32(cfg.width, eps=1e-5)
        if cfg.projection_dim is not None:
            self.visual_projection = Dense(cfg.width, cfg.projection_dim, cfg.dtype, bias=False)

    def forward(self, images: torch.Tensor) -> dict:
        cfg = self.cfg
        b = images.shape[0]
        x = self.patch_embedding(images.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B, N, D)
        cls = self.class_embedding.to(cfg.dtype).expand(b, 1, cfg.width)
        x = torch.cat([cls, x], dim=1)
        x = x + self.position_embedding[:x.shape[1]].to(cfg.dtype)
        x = self.pre_layernorm(x).to(cfg.dtype)
        x = _run_blocks(self, x, causal=False)
        pooled = self.post_layernorm(x[:, 0])
        out = {"tokens": x.to(cfg.dtype), "pooled": pooled.to(cfg.dtype)}
        if cfg.projection_dim is not None:
            out["image_embeds"] = self.visual_projection(pooled.to(cfg.dtype))
        return out


@torch.no_grad()
def init_clip_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Flax's initialisers for a CLIP tower: `init_params_`, then
    N(0, 0.02) token and class embeddings and N(0, 0.01) position
    embeddings."""
    from labelany3d_tpu_torch.models.weights import init_params_

    init_params_(model, gen)
    for name in ("token_embedding", "class_embedding", "position_embedding"):
        p = getattr(model, name, None)
        if p is not None:
            p.normal_(0.0, 0.01 if name == "position_embedding" else 0.02, generator=gen)
    return model


# CLIP's released preprocessing constants (image normalization).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_clip_image(rgb01: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[0, 1] RGB (H, W, 3) -> CLIP-normalized (size, size, 3) float32, on
    the tensor's device: 8 bits (truncated), Pillow's BICUBIC resize
    (`layers.resize_bicubic_8bit`), /255, normalized."""
    from labelany3d_tpu_torch.models.layers import resize_bicubic_8bit

    u8 = (rgb01.clamp(0, 1) * 255).to(torch.uint8)
    x = resize_bicubic_8bit(u8.permute(2, 0, 1)[None], (size, size))[0].permute(1, 2, 0)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x / 255.0 - mean) / std


# --------------------------------------------------------------- converters


def _t(w):
    return np.asarray(w).T


def _ln(state, pre):
    return {"scale": np.asarray(state[pre + ".weight"]),
            "bias": np.asarray(state[pre + ".bias"])}


def _lin(state, pre):
    d = {"kernel": _t(state[pre + ".weight"])}
    if pre + ".bias" in state:
        d["bias"] = np.asarray(state[pre + ".bias"])
    return d


def _clip_block(state, pre):
    return {
        "layer_norm1": _ln(state, pre + ".layer_norm1"),
        "layer_norm2": _ln(state, pre + ".layer_norm2"),
        "self_attn": {
            "q_proj": _lin(state, pre + ".self_attn.q_proj"),
            "k_proj": _lin(state, pre + ".self_attn.k_proj"),
            "v_proj": _lin(state, pre + ".self_attn.v_proj"),
            "out_proj": _lin(state, pre + ".self_attn.out_proj"),
        },
        "fc1": _lin(state, pre + ".mlp.fc1"),
        "fc2": _lin(state, pre + ".mlp.fc2"),
    }


def _strip(state: dict, prefix: str) -> dict:
    if any(k.startswith(prefix) for k in state):
        return ({k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
                | {k: v for k, v in state.items() if not k.startswith(prefix)})
    return state


def convert_clip_text(state: dict, cfg: CLIPTextConfig) -> dict:
    """transformers CLIPTextModel(WithProjection) state_dict -> Flax-layout
    params. Accepts keys with or without the `text_model.` prefix."""
    state = _strip(state, "text_model.")
    params = {
        "token_embedding": np.asarray(state["embeddings.token_embedding.weight"]),
        "position_embedding": np.asarray(state["embeddings.position_embedding.weight"]),
        "final_layer_norm": _ln(state, "final_layer_norm"),
    }
    for i in range(cfg.depth):
        params[f"layer{i}"] = _clip_block(state, f"encoder.layers.{i}")
    if cfg.projection_dim is not None:
        if "text_projection.weight" not in state:
            raise KeyError("checkpoint has no text_projection (plain CLIPTextModel); "
                           "use CLIPTextConfig(projection_dim=None)")
        params["text_projection"] = {"kernel": _t(state["text_projection.weight"])}
    return params


def convert_clip_vision(state: dict, cfg: CLIPVisionConfig) -> dict:
    """transformers CLIPVisionModel(WithProjection) state_dict -> Flax-layout
    params. Accepts keys with or without the `vision_model.` prefix. The HF
    patch embed is (D, 3, P, P); Flax wants (P, P, 3, D)."""
    state = _strip(state, "vision_model.")
    pe = np.asarray(state["embeddings.patch_embedding.weight"])
    params = {
        "patch_embedding": {"kernel": pe.transpose(2, 3, 1, 0)},
        "class_embedding": np.asarray(state["embeddings.class_embedding"]),
        "position_embedding": np.asarray(state["embeddings.position_embedding.weight"]),
        # HF spells it `pre_layrnorm` (sic); accept both.
        "pre_layernorm": _ln(
            state, "pre_layrnorm" if "pre_layrnorm.weight" in state else "pre_layernorm"),
        "post_layernorm": _ln(state, "post_layernorm"),
    }
    for i in range(cfg.depth):
        params[f"layer{i}"] = _clip_block(state, f"encoder.layers.{i}")
    if cfg.projection_dim is not None:
        if "visual_projection.weight" not in state:
            raise KeyError("checkpoint has no visual_projection (plain CLIPVisionModel); "
                           "use CLIPVisionConfig(projection_dim=None)")
        params["visual_projection"] = {"kernel": _t(state["visual_projection.weight"])}
    return params
