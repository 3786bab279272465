"""Model backends for the pipeline stages (real models or an analytic fake).

Counterpart of `labelany3d_tpu/pipeline/backends.py`: `TorchDepthBackend`
mirrors `JaxDepthBackend` (MoGe gives relative depth and intrinsics;
DepthPro, conditioned on MoGe's focal, gives metric depth),
`FakeDepthBackend` serves pre-registered analytic depth for tests, and
`TorchMatcherBackend` mirrors `JaxMatcherBackend` (TwoViewMatcher +
reciprocal NN) for the layout stage's registration. The stage-2 to stage-6
factories give the shipping defaults, the SD-class backends (`invsr`,
`our`, `zero123`), and stage 6's TRELLIS (`obj_rec=trellis`) and Hunyuan3D
(`obj_rec=hunyuan3d`, `hunyuan3d_carve`) backends.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from labelany3d_tpu_torch.models.depth_pro import (
    DepthPro35,
    DepthPro35Config,
    DepthProConfig,
    DepthProModel,
    depth_pro35_infer,
    depth_pro_infer,
)
from labelany3d_tpu_torch.models.layers import resize, resize_bicubic_8bit
from labelany3d_tpu_torch.models.moge import (
    MoGeConfig,
    MoGeModel,
    moge_infer,
    pixel_intrinsics_from_normalized,
)
from labelany3d_tpu_torch.models.registry import ModelRegistry
from labelany3d_tpu_torch.models.vit import ViTConfig
from labelany3d_tpu_torch.models.weights import (
    cast_inference_params_,
    flax_to_state_dict,
    init_params_,
)
from labelany3d_tpu_torch.utils.device import resolve_device


class DepthBackend(Protocol):
    """Batch depth inference: (B, H, W, 3) uint8 or float images in [0, 1] ->
    dict(relative_depth, metric_depth, depth_mask, K_pixels) on the device."""

    device: torch.device

    def infer(self, images: np.ndarray) -> dict: ...


class TorchDepthBackend:
    """MoGe -> DepthPro at one pinned resolution bucket.

    Models are built on first use at that bucket (`pin_hw`, else the first
    batch's size). `params_moge` / `params_depth_pro` are Flax-layout trees
    (the JAX package's parameters, or a released checkpoint through
    `models/convert.py`), loaded as they are. A model without them gets
    random weights from a `torch.Generator` seeded with `seed` (MoGe) or
    `seed + 1` (DepthPro), whose Dense/Conv weights are then cast to bf16
    once, as the JAX backend does for its random init.

    A `DepthPro35Config` selects the checkpoint-faithful 35-patch DepthPro,
    which runs at its fixed `img_size` (1536): the batch is resized to it,
    the focal scaled with the width, and the depth resized back.
    """

    def __init__(
        self,
        moge_cfg: MoGeConfig | None = None,
        depth_pro_cfg: DepthProConfig | DepthPro35Config | None = None,
        params_moge=None,
        params_depth_pro=None,
        seed: int = 0,
        pin_hw: tuple | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.moge_cfg = moge_cfg or MoGeConfig()
        self.dp_cfg = depth_pro_cfg or DepthProConfig()
        self._dp35 = isinstance(self.dp_cfg, DepthPro35Config)
        self._params = (params_moge, params_depth_pro)
        self._seed = seed
        self._hw = tuple(pin_hw) if pin_hw is not None else None
        self.moge: MoGeModel | None = None
        self.depth_pro: DepthProModel | DepthPro35 | None = None

    def _build(self, model: torch.nn.Module, params, seed: int) -> torch.nn.Module:
        if params is not None:
            model.load_state_dict(flax_to_state_dict(params, model))
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            cast_inference_params_(init_params_(model, gen))
        return model.eval().requires_grad_(False)

    def _ensure_models(self, h: int, w: int) -> None:
        if self.moge is not None:
            return
        if all(p is None for p in self._params):
            from labelany3d_tpu_torch.utils.logging import warn_once

            warn_once("depth_random",
                      "depth backend runs with random-initialized weights (no "
                      "converted MoGe/DepthPro checkpoint): depth maps and "
                      "intrinsics are not meaningful")
        hw = self._hw or (h, w)
        self._hw = hw
        with torch.device(self.device):
            self.moge = self._build(MoGeModel(self.moge_cfg, hw), self._params[0], self._seed)
            dp = DepthPro35(self.dp_cfg) if self._dp35 else DepthProModel(self.dp_cfg, hw)
            self.depth_pro = self._build(dp, self._params[1], self._seed + 1)
        self._params = (None, None)  # the models hold them now

    @torch.inference_mode()
    def infer(self, images) -> dict:
        b, h, w, _ = images.shape
        self._ensure_models(h, w)
        x = torch.as_tensor(np.asarray(images)).to(self.device)
        # uint8 batches normalise on the device: 4x fewer bytes to copy.
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        m = moge_infer(self.moge, x, apply_mask=True)
        K_pix = pixel_intrinsics_from_normalized(m["intrinsics"], w, h)
        if self._dp35:
            s = self.dp_cfg.img_size
            x_dp = resize(x.permute(0, 3, 1, 2), (s, s)).permute(0, 2, 3, 1)
            # The focal scales with the resize of the width axis.
            d = depth_pro35_infer(self.depth_pro, x_dp, f_px=K_pix[:, 0, 0] * (s / w))
            d = {"depth": resize(d["depth"][:, None], (h, w))[:, 0]}
        else:
            d = depth_pro_infer(self.depth_pro, x, f_px=K_pix[:, 0, 0])
        return {
            "relative_depth": m["depth"],
            "metric_depth": d["depth"],
            "depth_mask": m["mask"],
            "K_pixels": K_pix,
        }


class FakeDepthBackend:
    """Analytic backend for hermetic tests: rows of `infer` calls consume the
    pre-registered true depth maps in order."""

    def __init__(self, depths: np.ndarray, K: np.ndarray, relative_scale: float = 0.5,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.depths = np.asarray(depths, np.float32)
        self.K = np.asarray(K, np.float32)
        self.relative_scale = relative_scale
        self._cursor = 0

    def infer(self, images) -> dict:
        b = images.shape[0]
        sel = torch.as_tensor(self.depths[self._cursor:self._cursor + b], device=self.device)
        self._cursor += b
        K = torch.as_tensor(np.broadcast_to(self.K, (b, 3, 3)).copy(), device=self.device)
        return {
            "relative_depth": sel * self.relative_scale,
            "metric_depth": sel,
            "depth_mask": torch.ones_like(sel, dtype=torch.bool),
            "K_pixels": K,
        }


class TorchMatcherBackend:
    """Registration matcher: TwoViewMatcher + reciprocal NN, the
    `registration.process.MatcherBackend` protocol.

    The model is built on first use at the views' size. `params` is a
    Flax-layout tree (the JAX package's, or a released MASt3R checkpoint
    through `models/convert.py::convert_mast3r` for
    `MatcherConfig.mast3r_vitl()`), loaded as it is; without it the weights
    are random from a `torch.Generator` seeded with `seed`, as the JAX
    backend does without converted weights (registration poses are then
    meaningless). `tiny` selects `MatcherConfig.tiny_test()` (the default,
    as in the JAX package); `tiny=False` is the full-width `MatcherConfig()`.
    Every call is one matcher forward (counted in `forwards`) followed by
    one batched reciprocal-NN pass over all of its pairs.
    """

    def __init__(self, cfg=None, params=None, seed: int = 0, tiny: bool = True,
                 device: str | torch.device | None = None):
        from labelany3d_tpu_torch.models.matcher import MatcherConfig

        self.device = resolve_device(device)
        self.cfg = cfg or (MatcherConfig.tiny_test() if tiny else MatcherConfig())
        self.params = params
        self._seed = seed
        self.model = None
        self.forwards = 0

    def _ensure(self, h: int, w: int) -> None:
        """Build the model at the first views' token grid; views of another
        size later resize a learned pos-embed (a rope encoder has none)."""
        if self.model is not None:
            return
        from labelany3d_tpu_torch.models.matcher import TwoViewMatcher

        p = self.cfg.encoder.patch_size
        with torch.device(self.device):
            model = TwoViewMatcher(self.cfg, (h // p, w // p))
        if self.params is not None:
            model.load_state_dict(flax_to_state_dict(self.params, model))
            self.params = None  # the model holds them now
        else:
            from labelany3d_tpu_torch.utils.logging import warn_once

            warn_once("matcher_random",
                      "matcher backend runs with random-initialized descriptors (no "
                      "converted MASt3R checkpoint): registration poses and scales "
                      "are not meaningful")
            init_params_(model, torch.Generator(device=self.device).manual_seed(self._seed))
        self.model = model.eval().requires_grad_(False)

    @staticmethod
    def _prep_ref(ref_rgba: np.ndarray, h: int, w: int) -> np.ndarray:
        """The reference crop's RGB at the views' size. A crop of another
        size goes through 8 bits (truncated) and Pillow's default resize
        (bicubic), as in the JAX backend."""
        ref = np.asarray(ref_rgba, np.float32)[..., :3]
        if ref.shape[:2] != (h, w):
            x = torch.from_numpy((ref * 255).astype(np.uint8)).permute(2, 0, 1)[None]
            ref = resize_bicubic_8bit(x, (h, w))[0].permute(1, 2, 0).numpy() / np.float32(255.0)
        return ref

    @torch.inference_mode()
    def _run(self, refs: np.ndarray, views: np.ndarray, ref_index=None):
        """One forward over (R, h, w, 3) refs and (P, h, w, 3) views, then
        reciprocal NN over the P pairs; returns numpy (xy0, xy1, valid)."""
        from labelany3d_tpu_torch.ops.reciprocal_nn import reciprocal_nn_match

        self.forwards += 1
        dev = self.device
        idx = None if ref_index is None else torch.as_tensor(ref_index, device=dev)
        out = self.model(torch.as_tensor(refs, device=dev), torch.as_tensor(views, device=dev),
                         ref_index=idx)
        res = reciprocal_nn_match(out["desc0"], out["desc1"])
        return res.xy0.cpu().numpy(), res.xy1.cpu().numpy(), res.valid.cpu().numpy()

    def match(self, ref_rgba: np.ndarray, view) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        h, w = view.rgba.shape[:2]
        self._ensure(h, w)
        ref = self._prep_ref(ref_rgba, h, w)
        xy0, xy1, valid = self._run(ref[None], np.asarray(view.rgba, np.float32)[None, ..., :3])
        return xy0[0], xy1[0], valid[0]

    def match_batch(self, ref_rgba: np.ndarray, views) -> list[tuple]:
        """The reference crop against all `views` in one forward (the crop
        is encoded once and broadcast)."""
        if not views:
            return []
        h, w = views[0].rgba.shape[:2]
        self._ensure(h, w)
        ref = self._prep_ref(ref_rgba, h, w)
        imgs = np.stack([v.rgba[..., :3] for v in views]).astype(np.float32)
        xy0, xy1, valid = self._run(ref[None], imgs)
        return [(xy0[v], xy1[v], valid[v]) for v in range(len(views))]

    def match_pairs(self, refs: list[np.ndarray], views, ref_index: list[int]) -> list[tuple]:
        """All of an image's (reference crop, rendered view) pairs in one
        matcher forward. Counts are bucketed as in the JAX package (refs to
        a power of two, pairs to the same ratio, else a power of two)."""
        if not views:
            return []
        h, w = views[0].rgba.shape[:2]
        self._ensure(h, w)
        r, p = len(refs), len(views)
        rb = 1 << max(0, r - 1).bit_length()
        ratio = p // r if r and p % r == 0 else 0
        pb = ratio * rb if ratio else 1 << max(0, p - 1).bit_length()
        ref_arr = np.zeros((rb, h, w, 3), np.float32)
        for i, ref in enumerate(refs):
            ref_arr[i] = self._prep_ref(ref, h, w)
        view_arr = np.zeros((pb, h, w, 3), np.float32)
        for i, v in enumerate(views):
            view_arr[i] = v.rgba[..., :3]
        idx = np.zeros((pb,), np.int64)
        idx[:p] = np.asarray(ref_index, np.int64)
        xy0, xy1, valid = self._run(ref_arr, view_arr, idx)
        return [(xy0[i], xy1[i], valid[i]) for i in range(p)]


class ViewPairMatcher:
    """Stage 5's `pair_matcher`: two uint8 (H, W, 3) views -> (xy0, xy1,
    valid) through `matcher.match`, each view as an opaque RGBA in [0, 1]."""

    def __init__(self, matcher: TorchMatcherBackend):
        self.matcher = matcher

    @staticmethod
    def _rgba(img: np.ndarray) -> np.ndarray:
        return np.concatenate([img.astype(np.float32) / 255.0,
                               np.ones(img.shape[:2] + (1,), np.float32)], axis=-1)

    def __call__(self, img0: np.ndarray, img1: np.ndarray):
        from types import SimpleNamespace

        return self.matcher.match(self._rgba(img0), SimpleNamespace(rgba=self._rgba(img1)))


def make_depth(preset: str = "large", **kw) -> TorchDepthBackend:
    """Depth backend presets, as `register_default_backends().make_depth`."""
    if preset == "tiny_test":
        return TorchDepthBackend(MoGeConfig.tiny_test(), DepthProConfig.tiny_test(), **kw)
    if preset == "vitl_reference":
        # The released graphs: load converted weights through
        # models/convert.py and pass them as params_moge / params_depth_pro.
        return TorchDepthBackend(MoGeConfig.vitl(), DepthPro35Config(), **kw)
    if preset == "tiny_reference":
        return TorchDepthBackend(MoGeConfig.tiny_reference_test(), DepthPro35Config.tiny_test(),
                                 **kw)
    presets = {"small": ViTConfig.small, "base": ViTConfig.base, "large": ViTConfig.large}
    if preset not in presets:
        raise ValueError(f"Unknown models.moge.preset: {preset!r} (choose small | base | "
                         "large | tiny_test | vitl_reference | tiny_reference)")
    backbone = presets[preset]
    out_indices = (5, 11, 17, 23) if preset == "large" else (2, 5, 8, 11)
    return TorchDepthBackend(MoGeConfig(backbone=backbone(out_indices=out_indices)),
                             DepthProConfig(backbone=backbone()), **kw)


def _shipping_default(kind: str, backend: str, default: str, make):
    """`make()` for the stage's shipping-default backend name; raise for any
    other."""
    if backend != default:
        raise ValueError(f"Unknown {kind} backend {backend!r}")
    return make()


def make_enhance(backend: str = "bicubic", tiny: bool = False, device=None, seed: int = 0,
                 **_kw):
    """'bicubic' (the shipping default) or 'invsr': `InvSREnhance` at the
    SD-1.5 widths and 256 px (the tiny UNet and VAE at 64 px with `tiny`),
    random weights from `seed`."""
    if backend == "invsr":
        from labelany3d_tpu_torch.models.diffusion import InvSREnhance

        return InvSREnhance(tiny=tiny, image_size=64 if tiny else 256, seed=seed, device=device)
    from labelany3d_tpu_torch.pipeline.stages.generative import BicubicEnhance

    return _shipping_default("enhance", backend, "bicubic", lambda: BicubicEnhance(device=device))


def make_completion(backend: str = "none", tiny: bool = False, device=None, seed: int = 0,
                    segment=None, **_kw):
    """'none' (passthrough, the shipping default) or 'our': `AmodalCompletion`
    at the SD-1.5 widths and 256 px (tiny at 64 px with `tiny`);
    `segment='isnet'` re-segments each completed crop with ISNet for the
    amodal alpha."""
    if backend == "our":
        from labelany3d_tpu_torch.models.diffusion import AmodalCompletion

        return AmodalCompletion(tiny=tiny, image_size=64 if tiny else 256, seed=seed,
                                segmenter=True if segment in ("isnet", True) else None,
                                device=device)
    from labelany3d_tpu_torch.pipeline.stages.generative import PassthroughCompletion

    return _shipping_default("completion", backend, "none", PassthroughCompletion)


def make_elevation(backend: str = "zero", tiny: bool = False, device=None, seed: int = 0,
                   **_kw):
    """'zero' (the shipping default) or 'zero123': `MatchingElevationEstimator`
    over `Zero123NovelView` views (256 px, 64 with `tiny`) matched by a
    `TorchMatcherBackend` (tiny by default, as in the JAX package), with the
    render intrinsics scaled to the views' size."""
    if backend == "zero123":
        from labelany3d_tpu_torch.models.diffusion import Zero123NovelView
        from labelany3d_tpu_torch.models.elevation import MatchingElevationEstimator
        from labelany3d_tpu_torch.registration.cameras import RENDER_K

        nv = Zero123NovelView(tiny=tiny, image_size=64 if tiny else 256, seed=seed,
                              device=device)
        K = RENDER_K.copy()
        K[:2] *= nv.image_size / 512.0
        return MatchingElevationEstimator(
            nv, ViewPairMatcher(TorchMatcherBackend(seed=seed, device=device)), K)
    from labelany3d_tpu_torch.pipeline.stages.generative import ZeroElevation

    return _shipping_default("elevation", backend, "zero", ZeroElevation)


def make_reconstruction(backend: str = "silhouette", tiny: bool = False, device=None,
                        seed: int = 0, views: str = "mvd", **_kw):
    """Stage 6's backends, their weights random from `seed`:

      * 'silhouette' (the shipping default);
      * 'trellis': a `TrellisPipeline` at `TrellisPipelineConfig()` with its
        weights held in bf16, or at `tiny_test()` in float32 with `tiny`;
      * 'hunyuan3d': `SVRMReconstruction` at `SVRMConfig()` (`tiny_test()`
        with `tiny`) over the mvd_std grid diffusion's six views
        (`MVDStdViews`, the reference's view source), or with
        `views='zero123'` over `Zero123NovelView` views (256 px, 64 with
        `tiny`);
      * 'hunyuan3d_carve': `SpaceCarveReconstruction` (visual hull) over
        `Zero123NovelView` views."""
    if backend == "trellis":
        from labelany3d_tpu_torch.models.trellis import TrellisPipeline, TrellisPipelineConfig

        return TrellisPipeline(TrellisPipelineConfig.tiny_test() if tiny else None, seed=seed,
                               params_dtype=None if tiny else torch.bfloat16, device=device)
    if backend in ("hunyuan3d", "hunyuan3d_carve"):
        from labelany3d_tpu_torch.models.diffusion import MVDStdViews, Zero123NovelView

        if backend == "hunyuan3d" and views == "mvd":
            nv = MVDStdViews(tiny=tiny, seed=seed, device=device)
        elif views in ("mvd", "zero123"):
            nv = Zero123NovelView(tiny=tiny, image_size=64 if tiny else 256, seed=seed,
                                  device=device)
        else:
            raise ValueError(f"Unknown hunyuan3d view source {views!r} (choose mvd | zero123)")
        if backend == "hunyuan3d_carve":
            from labelany3d_tpu_torch.models.spacecarve import SpaceCarveReconstruction

            return SpaceCarveReconstruction(novel_views=nv, device=device)
        from labelany3d_tpu_torch.models.svrm import SVRMConfig, SVRMReconstruction

        return SVRMReconstruction(novel_views=nv, cfg=SVRMConfig.tiny_test() if tiny else None,
                                  seed=seed, device=device)
    from labelany3d_tpu_torch.pipeline.stages.generative import SilhouetteExtrude

    return _shipping_default("obj_rec", backend, "silhouette", SilhouetteExtrude)


def default_registry() -> ModelRegistry:
    """A registry with the production factories: 'depth', 'enhance',
    'completion', 'elevation', 'reconstruction' and 'matcher'."""
    reg = ModelRegistry()
    for name, factory in (("depth", make_depth), ("enhance", make_enhance),
                          ("completion", make_completion), ("elevation", make_elevation),
                          ("reconstruction", make_reconstruction),
                          ("matcher", TorchMatcherBackend)):
        reg.register(name, factory)
    return reg
