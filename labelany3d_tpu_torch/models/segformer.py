"""SegFormer semantic segmentation: the ADE20K thing/stuff foreground filter.

Counterpart of `labelany3d_tpu/models/segformer.py`, the reference's
OneFormer role (`src/model_wrappers.py:588-610`, thing/stuff overrides
:91-119): a hierarchical MiT encoder (overlapping patch convs, efficient
attention whose keys come from a strided-conv sequence reduction, Mix-FFN
with a depthwise 3x3 conv) and an all-MLP decode head giving ADE20K-150
logits at a quarter of the input size. `convert_segformer` renames a
`transformers` `SegformerForSemanticSegmentation` state dict
(nvidia/segformer-b*-finetuned-ade-512-512). The whole graph runs in
float32 (TF32 off), as the JAX package's does, whatever `cfg.dtype` says;
its attention is plain PyTorch (`layers.dense_attention`), as the JAX
package leaves it to XLA. Images are NHWC at the interface.
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
class SegFormerConfig:
    hidden_sizes: Sequence[int] = (32, 64, 160, 256)
    depths: Sequence[int] = (2, 2, 2, 2)
    num_heads: Sequence[int] = (1, 2, 5, 8)
    sr_ratios: Sequence[int] = (8, 4, 2, 1)
    patch_sizes: Sequence[int] = (7, 3, 3, 3)
    strides: Sequence[int] = (4, 2, 2, 2)
    mlp_ratios: Sequence[int] = (4, 4, 4, 4)
    decoder_hidden: int = 256
    num_labels: int = 150
    dtype: Any = torch.bfloat16  # unused: the graph runs in float32

    @staticmethod
    def b0(**kw) -> "SegFormerConfig":
        """nvidia/segformer-b0-finetuned-ade-512-512."""
        return SegFormerConfig(**kw)

    @staticmethod
    def b2(**kw) -> "SegFormerConfig":
        return SegFormerConfig(hidden_sizes=(64, 128, 320, 512), depths=(3, 4, 6, 3),
                               decoder_hidden=768, **kw)

    @staticmethod
    def tiny_test(**kw) -> "SegFormerConfig":
        return SegFormerConfig(hidden_sizes=(8, 16), depths=(1, 1), num_heads=(1, 2),
                               sr_ratios=(2, 1), patch_sizes=(7, 3), strides=(4, 2),
                               mlp_ratios=(2, 2), decoder_hidden=16, num_labels=6, **kw)


class _EfficientAttention(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr
        self.query = Dense(dim, dim, _F32)
        self.key = Dense(dim, dim, _F32)
        self.value = Dense(dim, dim, _F32)
        self.out = Dense(dim, dim, _F32)
        if sr > 1:
            self.sr = Conv(dim, dim, sr, _F32, stride=sr, padding=0)
            self.sr_norm = LayerNorm32(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:  # (B, N, C)
        b, n, c = x.shape
        q = self.query(x)
        kv_in = x
        if self.sr_ratio > 1:
            s = self.sr_ratio
            g = nchw(x.reshape(b, h, w, c))
            # Flax's SAME padding for kernel == stride: the shortfall to a
            # multiple of the stride, split low/high.
            ph, pw = -h % s, -w % s
            g = F.pad(g, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            kv_in = self.sr_norm(nhwc(self.sr(g)).reshape(b, -1, c))
        k, v = self.key(kv_in), self.value(kv_in)

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, c // self.heads)

        out = dense_attention(split(q), split(k), split(v)).reshape(b, n, c)
        return self.out(out)


class _MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.dense1 = Dense(dim, hidden, _F32)
        self.dwconv = Conv(hidden, hidden, 3, _F32, padding=1, groups=hidden)
        self.dense2 = Dense(hidden, dim, _F32)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, _ = x.shape
        x = self.dense1(x)
        g = self.dwconv(nchw(x.reshape(b, h, w, -1)))
        x = nhwc(g).reshape(b, n, -1)
        return self.dense2(F.gelu(x))


class _Stage(nn.Module):
    def __init__(self, cfg: SegFormerConfig, i: int, c_in: int):
        super().__init__()
        c, p = cfg.hidden_sizes[i], cfg.patch_sizes[i]
        self.depth = cfg.depths[i]
        self.patch_proj = Conv(c_in, c, p, _F32, stride=cfg.strides[i], padding=p // 2)
        self.patch_norm = LayerNorm32(c, eps=1e-5)
        for j in range(self.depth):
            self.add_module(f"norm1_{j}", LayerNorm32(c, eps=1e-5))
            self.add_module(f"attn_{j}", _EfficientAttention(c, cfg.num_heads[i],
                                                             cfg.sr_ratios[i]))
            self.add_module(f"norm2_{j}", LayerNorm32(c, eps=1e-5))
            self.add_module(f"ffn_{j}", _MixFFN(c, c * cfg.mlp_ratios[i]))
        self.stage_norm = LayerNorm32(c, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, Cin) -> (B, h, w, C)
        x = nhwc(self.patch_proj(nchw(x)))
        b, h, w, c = x.shape
        x = self.patch_norm(x.reshape(b, h * w, c))
        for j in range(self.depth):
            x = x + getattr(self, f"attn_{j}")(getattr(self, f"norm1_{j}")(x), h, w)
            x = x + getattr(self, f"ffn_{j}")(getattr(self, f"norm2_{j}")(x), h, w)
        return self.stage_norm(x).reshape(b, h, w, c)


class SegFormer(nn.Module):
    """(B, H, W, 3) preprocessed pixels -> (B, H/4, W/4, num_labels) logits."""

    def __init__(self, cfg: SegFormerConfig):
        super().__init__()
        self.cfg = cfg
        c_in = 3
        for i, c in enumerate(cfg.hidden_sizes):
            self.add_module(f"stage{i}", _Stage(cfg, i, c_in))
            c_in = c
        d = cfg.decoder_hidden
        for i, c in enumerate(cfg.hidden_sizes):
            self.add_module(f"linear_c{i}", Dense(c, d, _F32))
        self.linear_fuse = Conv(len(cfg.hidden_sizes) * d, d, 1, _F32, bias=False)
        # Inference-mode BatchNorm: an affine with the running statistics.
        self.bn_mean = nn.Parameter(torch.zeros(d))
        self.bn_var = nn.Parameter(torch.ones(d))
        self.bn_scale = nn.Parameter(torch.ones(d))
        self.bn_bias = nn.Parameter(torch.zeros(d))
        self.classifier = Conv(d, cfg.num_labels, 1, _F32)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x, feats = pixels.float(), []
        for i in range(len(cfg.depths)):
            x = getattr(self, f"stage{i}")(x)
            feats.append(x)
        th, tw = feats[0].shape[1:3]
        ups = []
        for i, f in enumerate(feats):
            f = nchw(getattr(self, f"linear_c{i}")(f))
            if f.shape[-2:] != (th, tw):
                f = resize(f, (th, tw), method="bilinear")
            ups.append(f)
        x = self.linear_fuse(torch.cat(ups[::-1], dim=1))

        def c(p):
            return p[:, None, None]

        x = (x - c(self.bn_mean)) * torch.rsqrt(c(self.bn_var) + 1e-5) * c(self.bn_scale) \
            + c(self.bn_bias)
        return nhwc(self.classifier(F.relu(x)))


# --------------------------------------------------------------- converter


def _lin(state, pre):
    d = {"kernel": np.asarray(state[pre + ".weight"]).T}
    if pre + ".bias" in state:
        d["bias"] = np.asarray(state[pre + ".bias"])
    return d


def _ln(state, pre):
    return {"scale": np.asarray(state[pre + ".weight"]),
            "bias": np.asarray(state[pre + ".bias"])}


def _conv(state, pre, bias=True):
    d = {"kernel": np.ascontiguousarray(
        np.transpose(np.asarray(state[pre + ".weight"]), (2, 3, 1, 0)))}
    if bias and pre + ".bias" in state:
        d["bias"] = np.asarray(state[pre + ".bias"])
    return d


def convert_segformer(state: dict, cfg: SegFormerConfig) -> dict:
    """transformers SegformerForSemanticSegmentation state_dict -> the
    Flax-layout tree (`models/weights.py::flax_to_state_dict` loads it)."""
    params: dict = {}
    enc = "segformer.encoder"
    for i in range(len(cfg.depths)):
        stage: dict = {
            "patch_proj": _conv(state, f"{enc}.patch_embeddings.{i}.proj"),
            "patch_norm": _ln(state, f"{enc}.patch_embeddings.{i}.layer_norm"),
            "stage_norm": _ln(state, f"{enc}.layer_norm.{i}"),
        }
        for j in range(cfg.depths[i]):
            blk = f"{enc}.block.{i}.{j}"
            stage[f"norm1_{j}"] = _ln(state, blk + ".layer_norm_1")
            stage[f"norm2_{j}"] = _ln(state, blk + ".layer_norm_2")
            attn = {
                "query": _lin(state, blk + ".attention.self.query"),
                "key": _lin(state, blk + ".attention.self.key"),
                "value": _lin(state, blk + ".attention.self.value"),
                "out": _lin(state, blk + ".attention.output.dense"),
            }
            if cfg.sr_ratios[i] > 1:
                attn["sr"] = _conv(state, blk + ".attention.self.sr")
                attn["sr_norm"] = _ln(state, blk + ".attention.self.layer_norm")
            stage[f"attn_{j}"] = attn
            dw = np.asarray(state[blk + ".mlp.dwconv.dwconv.weight"])
            stage[f"ffn_{j}"] = {
                "dense1": _lin(state, blk + ".mlp.dense1"),
                "dense2": _lin(state, blk + ".mlp.dense2"),
                # torch depthwise (C, 1, 3, 3) -> flax grouped (3, 3, 1, C)
                "dwconv": {"kernel": np.ascontiguousarray(dw.transpose(2, 3, 1, 0)),
                           "bias": np.asarray(state[blk + ".mlp.dwconv.dwconv.bias"])},
            }
        params[f"stage{i}"] = stage
    for i in range(len(cfg.depths)):
        params[f"linear_c{i}"] = _lin(state, f"decode_head.linear_c.{i}.proj")
    params["linear_fuse"] = _conv(state, "decode_head.linear_fuse", bias=False)
    params["bn_scale"] = np.asarray(state["decode_head.batch_norm.weight"])
    params["bn_bias"] = np.asarray(state["decode_head.batch_norm.bias"])
    params["bn_mean"] = np.asarray(state["decode_head.batch_norm.running_mean"])
    params["bn_var"] = np.asarray(state["decode_head.batch_norm.running_var"])
    params["classifier"] = _conv(state, "decode_head.classifier")
    return params


# ------------------------------------------------------- thing/stuff filter

# ADE20K-150 id2label as shipped in the HF SegFormer ADE checkpoints'
# config.json; the fallback when no config.json rides next to the weights.
ADE20K_ID2LABEL = {i: n for i, n in enumerate([
    "wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed ",
    "windowpane", "grass", "cabinet", "sidewalk", "person", "earth", "door",
    "table", "mountain", "plant", "curtain", "chair", "car", "water",
    "painting", "sofa", "shelf", "house", "sea", "mirror", "rug", "field",
    "armchair", "seat", "fence", "desk", "rock", "wardrobe", "lamp",
    "bathtub", "railing", "cushion", "base", "box", "column", "signboard",
    "chest of drawers", "counter", "sand", "sink", "skyscraper",
    "fireplace", "refrigerator", "grandstand", "path", "stairs", "runway",
    "case", "pool table", "pillow", "screen door", "stairway", "river",
    "bridge", "bookcase", "blind", "coffee table", "toilet", "flower",
    "book", "hill", "bench", "countertop", "stove", "palm",
    "kitchen island", "computer", "swivel chair", "boat", "bar",
    "arcade machine", "hovel", "bus", "towel", "light", "truck", "tower",
    "chandelier", "awning", "streetlight", "booth", "television receiver",
    "airplane", "dirt track", "apparel", "pole", "land", "bannister",
    "escalator", "ottoman", "bottle", "buffet", "poster", "stage", "van",
    "ship", "fountain", "conveyer belt", "canopy", "washer", "plaything",
    "swimming pool", "stool", "barrel", "basket", "waterfall", "tent",
    "bag", "minibike", "cradle", "oven", "ball", "food", "step", "tank",
    "trade name", "microwave", "pot", "animal", "bicycle", "lake",
    "dishwasher", "screen", "blanket", "sculpture", "hood", "sconce",
    "vase", "traffic light", "tray", "ashcan", "fan", "pier", "crt screen",
    "plate", "monitor", "bulletin board", "shower", "radiator", "glass",
    "clock", "flag",
])}


def _norm_label(name: str) -> str:
    """A class name across naming conventions (HF short names, detectron2's
    comma lists like 'column, pillar'): first comma segment, stripped,
    lowercased."""
    return name.split(",")[0].strip().lower()


# ADE20K "stuff" classes (detectron2 isthing=0) in normalised short names,
# adjusted as the reference adjusts OneFormer's metadata
# (`src/model_wrappers.py:91-119`): its `my_stuff` names demoted from thing
# to stuff, its `my_thing` names promoted back.
_BASE_STUFF = {
    "wall", "building", "sky", "floor", "tree", "ceiling", "road", "grass",
    "sidewalk", "earth", "mountain", "water", "sea", "field", "sand",
    "hill", "path", "runway", "dirt track", "land", "lake", "river",
    "stage", "waterfall", "swimming pool",
}
# my_stuff (model_wrappers.py:92-104), normalised: 'window ' matches both HF
# 'windowpane' and detectron2 'window'; 'rail' matches 'railing'.
_MY_STUFF = {
    "window", "windowpane", "door", "curtain", "mirror", "fence", "rail",
    "railing", "column", "stairs", "screen door", "bannister", "step",
    "stairway", "escalator", "bridge", "fountain", "pier",
}
# my_thing promotions (model_wrappers.py:106-112).
_MY_THING = {"plant", "tent", "crt screen", "cradle", "blanket"}

ADE20K_STUFF_NAMES = frozenset((_BASE_STUFF | _MY_STUFF) - _MY_THING)


def thing_ids_from_id2label(id2label: dict) -> np.ndarray:
    """Class indices whose (normalised) name is a thing under the
    reference-adjusted ADE20K split."""
    return np.array([int(i) for i, name in id2label.items()
                     if _norm_label(name) not in ADE20K_STUFF_NAMES], np.int64)


class SegformerForeground:
    """ForegroundBackend in the OneFormer filter's role: a pixel is
    foreground when its argmax class is a thing class. The forward runs on
    `device`; the resizes are Pillow's, as in the JAX package. `params` is a
    Flax-layout tree (from `convert_segformer`); without it the weights are
    random from a generator seeded with `seed`, with a one-shot warning."""

    def __init__(self, cfg: SegFormerConfig | None = None, params=None,
                 id2label: dict[int, str] | None = None, input_size: int = 512,
                 seed: int = 0, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg or SegFormerConfig.b0()
        self.params = params
        self.input_size = input_size
        self.seed = seed
        self.model: SegFormer | None = None
        self._lock = threading.Lock()
        if id2label is None and self.cfg.num_labels == len(ADE20K_ID2LABEL):
            id2label = ADE20K_ID2LABEL
        if id2label is None:
            id2label = {i: f"class_{i}" for i in range(self.cfg.num_labels)}
        self.thing_ids = thing_ids_from_id2label(id2label)
        if len(self.thing_ids) >= self.cfg.num_labels:
            from labelany3d_tpu_torch.utils.logging import warn_once

            warn_once("segformer_all_things",
                      "thing/stuff filter covers every class (no stuff name matched "
                      "id2label): foreground() degenerates to all-True; check the "
                      "checkpoint's id2label naming")

    def _ensure(self) -> None:
        # The stages call the provider from their prefetch threads.
        with self._lock:
            if self.model is not None:
                return
            from labelany3d_tpu_torch.models.weights import build_module

            if self.params is None:
                from labelany3d_tpu_torch.utils.logging import warn_once

                warn_once("segformer_random",
                          "semantic filter runs a random-initialized SegFormer (no ADE20K "
                          "checkpoint): thing/stuff filtering is not meaningful")
            self.model = build_module(lambda: SegFormer(self.cfg), self.device, self.params,
                                      self.seed)
            self.params = None  # the model holds them now

    @torch.inference_mode()
    def logits(self, image: np.ndarray) -> torch.Tensor:
        """uint8 RGB (H, W, 3) -> (1, s/4, s/4, num_labels) logits on
        `device`, after Pillow's BILINEAR resize to `input_size`^2 and the
        ImageNet normalisation."""
        from PIL import Image

        self._ensure()
        s = self.input_size
        proc = np.asarray(Image.fromarray(image).resize((s, s), Image.BILINEAR))
        x = (proc.astype(np.float32) / 255.0 - np.array([0.485, 0.456, 0.406]))
        x = x / np.array([0.229, 0.224, 0.225])
        with full_f32():
            return self.model(torch.as_tensor(x, dtype=torch.float32, device=self.device)[None])

    def semantic(self, image: np.ndarray) -> np.ndarray:
        """uint8 RGB (H, W, 3) -> (H, W) int class map."""
        from PIL import Image

        h, w = image.shape[:2]
        cls = self.logits(image)[0].argmax(-1).cpu().numpy()
        return np.asarray(Image.fromarray(cls.astype(np.int32), mode="I")
                          .resize((w, h), Image.NEAREST))

    def foreground(self, image: np.ndarray) -> np.ndarray:
        return np.isin(self.semantic(image), self.thing_ids)
