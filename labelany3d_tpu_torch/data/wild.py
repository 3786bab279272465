"""In-the-wild segmentation front-end (no COCONUT labels).

Counterpart of `labelany3d_tpu/data/wild.py`, for the reference's
`src/model_wrappers.py`:
  * `filter_component_masks` (:31-37): keep masks whose foreground overlap
    ratio exceeds 0.5;
  * `run_entityv2` (:482-543): class-agnostic instance masks, served by the
    SAM point-grid segmenter (`SamSegmentation`, `models/sam.py`);
  * `run_clipseg` (:549-582) and the OneFormer thing/stuff filter
    (:588-610): the foreground mask, from CLIPSeg (`ClipSegForeground`)
    or SegFormer's ADE20K classes (`models/segformer.py`);
  * `run_ovsam` (:616-632): open-vocabulary labels per mask (`ClipTagger`).

The shipped defaults are deterministic stand-ins (quantised-colour
components, a border-prior foreground, an 'object' tagger), so wild mode
runs with no weights at all. SAM and SegFormer run on `device`; CLIPSeg and
CLIP are `transformers` models, as in the JAX package, moved to `device`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

import numpy as np
import torch

from labelany3d_tpu_torch.data.coconut import InstanceSet
from labelany3d_tpu_torch.utils.device import resolve_device


def filter_component_masks(
    masks: np.ndarray, foreground_mask: np.ndarray, threshold: float = 0.5
) -> tuple[np.ndarray, np.ndarray]:
    """Split mask indices into (foreground, background) by overlap ratio,
    with the reference's 1e-6 numerator and denominator epsilons."""
    masks = np.asarray(masks, bool)
    fg = np.asarray(foreground_mask, bool)
    all_instances = np.arange(len(masks))
    ratio = ((masks & fg).sum((-1, -2)) + 1e-6) / (masks.sum((-1, -2)) + 1e-6)
    is_fg = ratio > threshold
    return all_instances[is_fg], all_instances[~is_fg]


class SegmentationBackend(Protocol):
    def segment(self, image: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> (I, H, W) bool class-agnostic instance masks."""
        ...


class ForegroundBackend(Protocol):
    def foreground(self, image: np.ndarray) -> np.ndarray:
        """(H, W, 3) -> (H, W) bool foreground mask."""
        ...


class TaggerBackend(Protocol):
    def tag(self, image: np.ndarray, masks: np.ndarray) -> list[str]:
        """Per-mask category names."""
        ...


class ColorSegmentation:
    """Deterministic class-agnostic baseline: quantised-colour connected
    components (OpenCV), largest first."""

    def __init__(self, levels: int = 4, min_area: int = 400, max_instances: int = 16):
        self.levels = levels
        self.min_area = min_area
        self.max_instances = max_instances

    def segment(self, image: np.ndarray) -> np.ndarray:
        import cv2

        img = np.asarray(image)
        q = (img // (256 // self.levels)).astype(np.int32)
        label_img = q[..., 0] * self.levels * self.levels + q[..., 1] * self.levels + q[..., 2]
        masks = []
        for value in np.unique(label_img):
            region = (label_img == value).astype(np.uint8)
            n, comp = cv2.connectedComponents(region)
            for c in range(1, n):
                m = comp == c
                if m.sum() >= self.min_area:
                    masks.append(m)
        masks.sort(key=lambda m: -m.sum())
        masks = masks[: self.max_instances]
        if not masks:
            return np.zeros((0,) + img.shape[:2], bool)
        return np.stack(masks)


class SamSegmentation:
    """Learned class-agnostic segmenter (the reference's EntityV2 role): the
    SAM point-grid auto-segmenter (`models/sam.py`) on `device`, its first
    `max_instances` masks. `params` is a Flax-layout tree (from
    `convert_sam`); without it the weights are random, with a one-shot
    warning. Other keyword arguments go to `SamAutoSegmentation`."""

    def __init__(self, cfg=None, params=None, max_instances: int = 16,
                 points_per_side: int = 8, device: str | torch.device | None = None, **kw):
        from labelany3d_tpu_torch.models.sam import SamAutoSegmentation, SamConfig

        self.auto = SamAutoSegmentation(cfg or SamConfig.vit_base(), params=params,
                                        points_per_side=points_per_side, device=device, **kw)
        self.max_instances = max_instances

    def segment(self, image: np.ndarray) -> np.ndarray:
        masks = self.auto.segment(np.asarray(image, np.uint8))[: self.max_instances]
        if not masks:
            return np.zeros((0,) + image.shape[:2], bool)
        return np.stack(masks)


class BorderPriorForeground:
    """CLIPSeg stand-in: pixels whose colour matches the image border's
    median colour are background; the rest is foreground."""

    def __init__(self, border: int = 8, tol: int = 30):
        self.border = border
        self.tol = tol

    def foreground(self, image: np.ndarray) -> np.ndarray:
        img = np.asarray(image, np.int32)
        b = self.border
        border_px = np.concatenate(
            [img[:b].reshape(-1, 3), img[-b:].reshape(-1, 3),
             img[:, :b].reshape(-1, 3), img[:, -b:].reshape(-1, 3)]
        )
        bg_color = np.median(border_px, axis=0)
        dist = np.abs(img - bg_color).sum(axis=-1)
        return dist > self.tol


class ConstantTagger:
    """OVSAM stand-in: labels every mask 'object'."""

    def tag(self, image: np.ndarray, masks: np.ndarray) -> list[str]:
        return ["object"] * len(masks)


@dataclass
class WildInstanceSource:
    """Instances of an unlabeled image (the reference's stack E: entityv2 ->
    clipseg/oneformer filter -> ovsam tags)."""

    segmentation: SegmentationBackend
    foreground: ForegroundBackend
    tagger: TaggerBackend
    overlap_threshold: float = 0.5

    def read_instances(self, image: np.ndarray) -> InstanceSet:
        masks = self.segmentation.segment(image)
        h, w = image.shape[:2]
        if len(masks) == 0:
            return InstanceSet(bboxes=np.zeros((0, 4)), masks=np.zeros((0, h, w), bool),
                               labels=[], category_ids=[])
        fg = self.foreground.foreground(image)
        keep, _drop = filter_component_masks(masks, fg, self.overlap_threshold)
        masks = masks[keep]
        labels = self.tagger.tag(image, masks)
        bboxes = []
        for m in masks:
            ys, xs = np.nonzero(m)
            bboxes.append([xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1])
        return InstanceSet(bboxes=np.asarray(bboxes, np.float64).reshape(-1, 4), masks=masks,
                           labels=labels, category_ids=[-1] * len(masks))


class ClipSegForeground:
    """Text-prompted foreground filter with the reference's `run_clipseg`
    semantics: per-prompt sigmoid maps, background prompts thresholded at
    0.5 and OR-reduced, foreground prompts at 0.1, mask = ~any(background) |
    any(foreground), resized to the image.

    A `transformers` `CLIPSegForImageSegmentation` on `device`. Pass
    `model_path` (a local `CIDAS/clipseg-rd64-refined` snapshot) or inject
    (model, processor). `transformers` is imported here only.
    """

    BACKGROUND_PROMPTS = ("background", "floor", "wall", "curtain", "window",
                          "ceiling", "table")
    FOREGROUND_PROMPTS = ("object", "furniture")

    def __init__(self, model_path: str | None = None, model=None, processor=None,
                 bg_threshold: float = 0.5, fg_threshold: float = 0.1,
                 device: str | torch.device | None = None):
        if model is None:
            from transformers import CLIPSegForImageSegmentation, CLIPSegProcessor

            model = CLIPSegForImageSegmentation.from_pretrained(model_path)
            processor = CLIPSegProcessor.from_pretrained(model_path)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.processor = processor
        self.bg_threshold = bg_threshold
        self.fg_threshold = fg_threshold

    @torch.inference_mode()
    def _predict_maps(self, image: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> (P, h, w) sigmoid maps, prompts = bg + fg."""
        from PIL import Image

        prompts = list(self.BACKGROUND_PROMPTS) + list(self.FOREGROUND_PROMPTS)
        pil = Image.fromarray(np.asarray(image, np.uint8))
        inputs = self.processor(text=prompts, images=[pil] * len(prompts),
                                padding="max_length", return_tensors="pt")
        logits = self.model(**inputs.to(self.device)).logits
        if logits.dim() == 2:  # single-image squeeze
            logits = logits[None]
        return torch.sigmoid(logits).cpu().numpy()

    def foreground(self, image: np.ndarray) -> np.ndarray:
        from PIL import Image

        maps = self._predict_maps(image)
        fg = combine_prompt_maps(maps, len(self.BACKGROUND_PROMPTS), self.bg_threshold,
                                 self.fg_threshold)
        h, w = np.asarray(image).shape[:2]
        return np.array(Image.fromarray(fg).resize((w, h)))


def combine_prompt_maps(maps: np.ndarray, n_background: int,
                        bg_threshold: float = 0.5, fg_threshold: float = 0.1) -> np.ndarray:
    """run_clipseg's threshold/OR logic (`model_wrappers.py:577-580`)."""
    maps = np.asarray(maps)
    back = (maps[:n_background] > bg_threshold).any(axis=0)
    fore = (maps[n_background:] > fg_threshold).any(axis=0)
    return ~back | fore


class ClipTagger:
    """Open-vocabulary per-mask tagger (the reference's `run_ovsam` role):
    crop each mask's box, score it against a vocabulary with CLIP, return
    the best name. A `transformers` `CLIPModel` on `device`; pass
    `model_path` or inject (model, processor). The vocabulary defaults to
    the Omni3D category names."""

    def __init__(self, model_path: str | None = None, model=None, processor=None,
                 vocabulary: list[str] | None = None,
                 device: str | torch.device | None = None):
        if model is None:
            from transformers import CLIPModel, CLIPProcessor

            model = CLIPModel.from_pretrained(model_path)
            processor = CLIPProcessor.from_pretrained(model_path)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.processor = processor
        if vocabulary is None:
            from labelany3d_tpu_torch.data.categories import OMNI3D_CATEGORIES

            vocabulary = [c["name"] for c in OMNI3D_CATEGORIES]
        self.vocabulary = list(vocabulary)

    @torch.inference_mode()
    def tag(self, image: np.ndarray, masks: np.ndarray) -> list[str]:
        from PIL import Image

        img = np.asarray(image, np.uint8)
        crops = []
        for m in np.asarray(masks, bool):
            ys, xs = np.nonzero(m)
            if len(ys) == 0:
                crops.append(Image.fromarray(img))
                continue
            crops.append(Image.fromarray(img[ys.min():ys.max() + 1, xs.min():xs.max() + 1]))
        if not crops:
            return []
        prompts = [f"a photo of a {name}" for name in self.vocabulary]
        inputs = self.processor(text=prompts, images=crops, padding="max_length",
                                return_tensors="pt", truncation=True)
        sims = self.model(**inputs.to(self.device)).logits_per_image  # (I, V)
        best = sims.argmax(dim=-1).cpu().numpy()
        return [self.vocabulary[int(i)] for i in best]


def default_wild_source() -> WildInstanceSource:
    return WildInstanceSource(ColorSegmentation(), BorderPriorForeground(), ConstantTagger())


def _load_state(path: str) -> dict:
    """A torch state dict file -> {name: float numpy array}."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in state.items()}


def make_wild_source(
    foreground: str = "border",
    tagger: str = "constant",
    segmentation: str = "color",
    clipseg_path: str | None = None,
    clip_path: str | None = None,
    sam_path: str | None = None,
    segformer_path: str | None = None,
    device: str | torch.device | None = None,
) -> WildInstanceSource:
    """Config-driven wild stack (CLI keys run.wild_segmentation /
    run.wild_foreground / run.wild_tagger; model paths under models.*),
    with every learned backend on `device`."""
    if segmentation in ("sam", "entityv2"):  # 'entityv2' = the reference's
        # config name for the class-agnostic segmenter role; served by SAM.
        params = None
        if sam_path is not None:
            from labelany3d_tpu_torch.models.sam import SamConfig, convert_sam

            params = convert_sam(_load_state(sam_path), SamConfig.vit_base())
        seg = SamSegmentation(params=params, device=device)
    elif segmentation == "color":
        seg = ColorSegmentation()
    else:
        raise ValueError(f"Unknown run.wild_segmentation: {segmentation!r} "
                         "(expected 'color', 'sam' or 'entityv2')")
    if foreground == "border":
        fg = BorderPriorForeground()
    elif foreground == "clipseg":
        if clipseg_path is None:
            raise ValueError("run.wild_foreground=clipseg needs models.clipseg_path")
        fg = ClipSegForeground(model_path=clipseg_path, device=device)
    elif foreground in ("semantic", "oneformer"):  # the reference's
        # ADE20K thing/stuff filter role, served by the SegFormer graph.
        from labelany3d_tpu_torch.models.segformer import (
            SegFormerConfig,
            SegformerForeground,
            convert_segformer,
        )

        params = id2label = None
        if segformer_path is not None:
            import json
            import os

            params = convert_segformer(_load_state(segformer_path), SegFormerConfig.b0())
            # HF snapshots ship id2label in config.json next to the weights;
            # SegformerForeground falls back to the ADE20K-150 table.
            cfg_json = os.path.join(os.path.dirname(segformer_path), "config.json")
            if os.path.isfile(cfg_json):
                with open(cfg_json) as f:
                    raw = json.load(f).get("id2label")
                if raw:
                    id2label = {int(k): v for k, v in raw.items()}
        fg = SegformerForeground(params=params, id2label=id2label, device=device)
    else:
        raise ValueError(f"Unknown run.wild_foreground: {foreground!r} "
                         "(expected 'border', 'clipseg' or 'semantic')")
    if tagger == "constant":
        tg = ConstantTagger()
    elif tagger == "clip":
        if clip_path is None:
            raise ValueError("run.wild_tagger=clip needs models.clip_path")
        tg = ClipTagger(model_path=clip_path, device=device)
    else:
        raise ValueError(f"Unknown run.wild_tagger: {tagger!r} "
                         "(expected 'constant' or 'clip')")
    return WildInstanceSource(seg, fg, tg)
