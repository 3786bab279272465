"""Image -> 3D pipeline (TrellisImageTo3DPipeline equivalent).

Counterpart of `labelany3d_tpu/models/trellis/pipeline.py`:

  preprocess (alpha crop, square pad, 8-bit bilinear resize to 518) ->
  DINOv2 conditioning (layer-normed prenorm tokens; K1 on the card) ->
  sample_sparse_structure (flow DiT over a 16^3 latent, CFG as one batch of
  2, K2; conv decoder; top-K occupancy) -> sample_slat (sparse UNet flow
  DiT over the voxels, K2 with segment ids in its torso) -> decode
  (Gaussians + FlexiCubes features) -> surface and texture bake (GLB mesh).

Weights: Flax-layout trees by component (`params={"cond": ..., "ss": ...}`,
from `models/convert_trellis.py` for a release, or read from the store
under `ckpt_dir` that the convert CLI's `trellis_*` entries write) through
`flax_to_state_dict`, or random ones from a `torch.Generator` with Flax's
initialisers, zero-initialised gates and output layers included (so the
flows return their noise and the mesh decoder's field is flat, as in the
JAX package). Random draws (the two flows' noise) come from `draws(name,
shape)` when given, else from a generator seeded by `run`'s seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from labelany3d_tpu_torch.data.meshio import Mesh
from labelany3d_tpu_torch.models.layers import layer_norm, resize_bilinear_8bit
from labelany3d_tpu_torch.models.trellis.decoders import (
    GaussianRepConfig,
    SLatDecoderConfig,
    SLatGaussianDecoder,
    SLatMeshDecoder,
    flexicubes_to_mesh,
)
from labelany3d_tpu_torch.models.trellis.samplers import FlowSamplerConfig, flow_euler_sample
from labelany3d_tpu_torch.models.trellis.slat import SLatConfig, SLatFlowModel, SparseConv3d
from labelany3d_tpu_torch.models.trellis.sparse_structure import (
    SparseStructureConfig,
    SparseStructureFlowModel,
    SSDecoderConfig,
    StructureDecoder,
    decode_occupancy,
)
from labelany3d_tpu_torch.models.vit import ViT, ViTConfig
from labelany3d_tpu_torch.models.weights import flax_to_state_dict, init_params_
from labelany3d_tpu_torch.utils.device import resolve_device
from labelany3d_tpu_torch.utils.profiling import StageTimer

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
COMPONENTS = ("cond", "ss", "ss_dec", "slat", "gs", "mesh")


@dataclasses.dataclass(frozen=True)
class TrellisPipelineConfig:
    # dinov2_vitl14_reg, the conditioner the released image pipeline loads.
    cond_backbone: ViTConfig = dataclasses.field(
        default_factory=lambda: ViTConfig.large(num_register_tokens=4, pos_grid=(37, 37)))
    cond_size: int = 518
    structure: SparseStructureConfig = dataclasses.field(default_factory=SparseStructureConfig)
    ss_dec: SSDecoderConfig = dataclasses.field(default_factory=SSDecoderConfig)
    slat: SLatConfig = dataclasses.field(default_factory=SLatConfig)
    dec_gs: SLatDecoderConfig = dataclasses.field(default_factory=SLatDecoderConfig)
    dec_mesh: SLatDecoderConfig = dataclasses.field(default_factory=SLatDecoderConfig)
    gs_rep: GaussianRepConfig = dataclasses.field(default_factory=GaussianRepConfig)
    ss_sampler: FlowSamplerConfig = FlowSamplerConfig(steps=25, cfg_strength=7.5, rescale_t=3.0)
    slat_sampler: FlowSamplerConfig = FlowSamplerConfig(steps=25, cfg_strength=3.0)
    max_voxels: int = 8192
    # The release's per-channel SLat de-normalisation (identity until real
    # statistics are installed).
    slat_mean: tuple = (0.0,) * 8
    slat_std: tuple = (1.0,) * 8

    @staticmethod
    def tiny_test() -> "TrellisPipelineConfig":
        return TrellisPipelineConfig(
            cond_backbone=ViTConfig.tiny_test(num_register_tokens=1),
            cond_size=32,
            structure=SparseStructureConfig.tiny_test(),
            ss_dec=SSDecoderConfig.tiny_test(),
            slat=SLatConfig.tiny_test(),
            dec_gs=SLatDecoderConfig.tiny_test(),
            dec_mesh=SLatDecoderConfig.tiny_test(),
            gs_rep=GaussianRepConfig(num_gaussians=4),
            ss_sampler=FlowSamplerConfig(steps=4, cfg_strength=3.0),
            slat_sampler=FlowSamplerConfig(steps=4, cfg_strength=1.5),
            max_voxels=256,
            slat_mean=(0.0,) * 4,
            slat_std=(1.0,) * 4,
        )


@torch.no_grad()
def init_trellis_params_(model: torch.nn.Module, gen: torch.Generator) -> torch.nn.Module:
    """Flax's initialisers for a TRELLIS module: `init_params_`, lecun-normal
    sparse-conv kernels, and zeros for the layers the JAX package
    zero-initialises (adaLN modulations, output layers, second convs)."""
    init_params_(model, gen)
    for m in model.modules():
        if isinstance(m, SparseConv3d):
            m.reset_parameters_(gen)
        elif getattr(m, "zero_init", False):
            m.weight.zero_()
            m.bias.zero_()
    return model


class TrellisPipeline:
    """The six components on `device`; `params_dtype=torch.bfloat16` holds
    every floating parameter in bf16 (the full-width serving precision, as
    the JAX backend's); None keeps float32."""

    # The store's names (`<ckpt_dir>/<name>/`), which the convert CLI's
    # `trellis_*` entries write, by component.
    CKPT_NAMES = {"cond": "trellis_cond", "ss": "trellis_ss_flow", "ss_dec": "trellis_ss_dec",
                  "slat": "trellis_slat_flow", "gs": "trellis_slat_gs",
                  "mesh": "trellis_slat_mesh"}

    def __init__(self, cfg: TrellisPipelineConfig | None = None, seed: int = 0,
                 params: dict | None = None, params_dtype: torch.dtype | None = None,
                 device: str | torch.device | None = None, ckpt_dir: str | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg or TrellisPipelineConfig()
        self.models: dict | None = None  # built on first use
        self._params = dict(params or {})
        self._params_dtype = params_dtype
        self._seed = seed
        self._ckpt_dir = ckpt_dir

    def _build(self) -> dict:
        c = self.cfg
        # Flax takes the cross-attention input width from the tokens; here
        # it is the conditioner's width.
        w = c.cond_backbone.width
        ss = dataclasses.replace(c.structure, dit=dataclasses.replace(c.structure.dit, cond_dim=w))
        slat = dataclasses.replace(c.slat, dit=dataclasses.replace(c.slat.dit, cond_dim=w))
        g = c.cond_size // c.cond_backbone.patch_size
        with torch.device(self.device):
            return {
                "cond": ViT(c.cond_backbone, (g, g)),
                "ss": SparseStructureFlowModel(ss),
                "ss_dec": StructureDecoder(c.ss_dec, latent_res=c.structure.latent_res),
                "slat": SLatFlowModel(slat),
                "gs": SLatGaussianDecoder(c.dec_gs, c.gs_rep),
                "mesh": SLatMeshDecoder(c.dec_mesh),
            }

    def init_params(self) -> None:
        """Build the six components; load each one's Flax-layout tree when
        given in `params`, else from the store under `ckpt_dir` (its
        `CKPT_NAMES` entry, one component in memory at a time), else draw
        random weights (component i from a generator seeded `seed + i`);
        then cast to the serving dtype and freeze. A store that lacks some
        components warns with their names (`trellis_partial_ckpt`, as the
        JAX package does); no converted weights at all warns
        `trellis_random`."""
        from labelany3d_tpu_torch.models.checkpoints import load_params
        from labelany3d_tpu_torch.utils.logging import warn_once

        models = self._build()
        missing = []
        for i, name in enumerate(COMPONENTS):
            model = models[name]
            tree = self._params.pop(name, None)
            if tree is None and self._ckpt_dir:
                tree = load_params(self._ckpt_dir, self.CKPT_NAMES[name])
            if tree is not None:
                model.load_state_dict(flax_to_state_dict(tree, model))
                del tree
            else:
                missing.append(name)
                init_trellis_params_(model, torch.Generator(device=self.device).manual_seed(
                    self._seed + i))
            if self._params_dtype is not None:
                for p in model.parameters():
                    p.data = p.data.to(self._params_dtype)
            model.eval().requires_grad_(False)
        if len(missing) == len(COMPONENTS):
            warn_once("trellis_random", "TRELLIS runs with random-initialized weights (no "
                      "converted checkpoint): generated meshes are not meaningful")
        elif missing and self._ckpt_dir:
            warn_once("trellis_partial_ckpt",
                      f"TRELLIS components {[self.CKPT_NAMES[k] for k in missing]} not found "
                      f"under {self._ckpt_dir}: those run with random weights (convert them "
                      "with `python -m labelany3d_tpu_torch.models.convert_cli trellis_*`)")
        self.models = models

    def _ensure(self) -> None:
        if self.models is None:
            self.init_params()

    # -- stages -----------------------------------------------------------
    def preprocess(self, rgba: np.ndarray, segmenter=None) -> torch.Tensor:
        """Alpha-crop to the object's box, pad square (black), resize to
        `cond_size` as Pillow's 8-bit BILINEAR does; (S, S, 3) float32 in
        [0, 1] on the device. An image without alpha goes through
        `segmenter.remove` when one is given (the reference's background
        removal, e.g. `models/saliency.py::RembgSegmenter`), else is taken
        whole."""
        img = np.asarray(rgba)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if img.shape[-1] != 4 and segmenter is not None:
            img = segmenter.remove(img)
        if img.shape[-1] == 4:
            alpha = img[..., 3] > 127
            rgb = img[..., :3] * alpha[..., None]
        else:
            alpha = np.ones(img.shape[:2], bool)
            rgb = img[..., :3]
        ys, xs = np.nonzero(alpha)
        if len(ys):
            rgb = rgb[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
        h, w = rgb.shape[:2]
        side = max(h, w)
        sq = np.zeros((side, side, 3), np.uint8)
        sq[(side - h) // 2:(side - h) // 2 + h, (side - w) // 2:(side - w) // 2 + w] = rgb
        x = torch.from_numpy(sq).to(self.device).permute(2, 0, 1)[None]
        s = self.cfg.cond_size
        return resize_bilinear_8bit(x, (s, s))[0].permute(1, 2, 0) / 255.0

    @torch.inference_mode()
    def get_cond(self, image: torch.Tensor):
        """(cond, uncond) tokens: the conditioner's prenorm tokens (prefix +
        patches) of the ImageNet-normalised image, layer-normed without
        affine, float32; uncond is zeros."""
        self._ensure()
        mean = torch.tensor(_IMAGENET_MEAN, device=self.device)
        std = torch.tensor(_IMAGENET_STD, device=self.device)
        feats = self.models["cond"](((image - mean) / std)[None])["all_prenorm"]
        tokens = layer_norm(feats, 1e-5)
        return tokens, torch.zeros_like(tokens)

    @torch.inference_mode()
    def ss_latent(self, cond, uncond, noise: torch.Tensor) -> torch.Tensor:
        """The SS flow from `noise` (1, R^3, C) to the structure latent, CFG
        as one batch of 2 (cond | uncond; t scaled by 1000)."""
        self._ensure()
        c = self.cfg
        tok2 = torch.cat([cond, uncond])
        s = c.ss_sampler.cfg_strength

        def vel(x, t):
            v = self.models["ss"](x.expand(2, *x.shape[1:]), (1000.0 * t).expand(2), tok2)
            return (1.0 + s) * v[:1] - s * v[1:]

        return flow_euler_sample(vel, noise, c.ss_sampler)

    @torch.inference_mode()
    def sample_sparse_structure(self, cond, uncond, noise: torch.Tensor):
        """`ss_latent`, the decoder, top-K occupancy -> (coords
        (1, max_voxels, 3), valid (1, max_voxels))."""
        latent = self.ss_latent(cond, uncond, noise)
        return decode_occupancy(self.models["ss_dec"](latent), self.cfg.max_voxels)

    def slat_buckets(self, coords: torch.Tensor, valid: torch.Tensor) -> tuple[int, int]:
        """(fine, torso) slot buckets from the actual voxel set: the valid
        prefix rounded up to 1024, and its factor-2 parent-cell count rounded
        up to 512 (at least 512, at most the fine bucket). A set that is
        empty or not a prefix keeps the full budget."""
        max_voxels = self.cfg.max_voxels
        v = valid.reshape(-1).cpu().numpy()
        n_real = int(v.sum())
        if n_real == 0 or (n_real < v.size and v[n_real:].any()):
            return max_voxels, max_voxels
        n_fine = min(max_voxels, -(-n_real // 1024) * 1024)
        pc = coords.reshape(-1, 3)[:n_real].cpu().numpy().astype(np.int64) // 2
        n_parent = len(np.unique((pc[:, 0] << 32) | (pc[:, 1] << 16) | pc[:, 2]))
        return n_fine, min(n_fine, max(512, -(-n_parent // 512) * 512))

    @torch.inference_mode()
    def sample_slat(self, coords, valid, cond, uncond, noise: torch.Tensor):
        """SLat flow over the first `n_fine` slots from `noise`
        (1, n_fine, C) (`slat_buckets`), CFG as one batch of 2, torso at the
        torso bucket; de-normalised and zero-padded to (1, max_voxels, C)."""
        self._ensure()
        c = self.cfg
        n_fine, torso = self.slat_buckets(coords, valid)
        if tuple(noise.shape[:2]) != (1, n_fine):
            raise ValueError(f"SLat noise must be (1, {n_fine}, C), got {tuple(noise.shape)}")
        coords2 = coords[:, :n_fine].expand(2, -1, -1)
        valid2 = valid[:, :n_fine].expand(2, -1)
        tok2 = torch.cat([cond, uncond])
        s = c.slat_sampler.cfg_strength

        def vel(x, t):
            v = self.models["slat"](x.expand(2, *x.shape[1:]), coords2, valid2,
                                    (1000.0 * t).expand(2), tok2, torso_slots=torso)
            return (1.0 + s) * v[:1] - s * v[1:]

        slat = flow_euler_sample(vel, noise, c.slat_sampler)
        slat = (slat * torch.tensor(c.slat_std, device=slat.device)
                + torch.tensor(c.slat_mean, device=slat.device))
        return torch.nn.functional.pad(slat, (0, 0, 0, c.max_voxels - n_fine))

    @torch.inference_mode()
    def decode(self, slat, coords, valid):
        """(GaussianSet, (mesh features, coords, valid)) of the first instance."""
        self._ensure()
        return (self.models["gs"](slat[0], coords[0], valid[0]),
                self.models["mesh"](slat[0], coords[0], valid[0]))

    @contextlib.contextmanager
    def _span(self, timer: StageTimer | None, name: str):
        """`timer.measure(name)` around the block, the device's queue drained
        before the span closes; nothing without a timer."""
        if timer is None:
            yield
            return
        with timer.measure(name):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def to_glb_mesh(self, gs, mesh_out, bake: str = "texture", texture_size: int = 256,
                    timer: StageTimer | None = None) -> Mesh:
        """Surface from the FlexiCubes field (host marching tetrahedra), then
        colour: 'texture' bakes a UV atlas from splat renders (TEXCOORD_0 +
        baseColor), 'render' bakes vertex colours from them, 'vertex' keeps
        the mesh decoder's own colours. Vertices centred in [-0.5, 0.5]^3.
        `timer` gets the spans "flexicubes_to_mesh" and "bake"."""
        from labelany3d_tpu_torch.models.trellis.bake import bake_texture, bake_vertex_colors

        with self._span(timer, "flexicubes_to_mesh"):
            feats, coords, valid = (t.float().cpu().numpy() if t.is_floating_point()
                                    else t.cpu().numpy() for t in mesh_out)
            verts, faces, vcols = flexicubes_to_mesh(feats, coords, valid,
                                                     self.cfg.dec_mesh.resolution * 4)
        # The bake works in the Gaussians' [0, 1]^3 object frame.
        mesh = Mesh(vertices=(verts + 0.5).astype(np.float32), faces=faces)
        with self._span(timer, "bake"):
            ok = bool((gs.valid & (gs.opacities > 0.01)).any())
            if ok and len(verts) and bake != "vertex":
                if bake == "texture":
                    mesh = bake_texture(mesh, gs, texture_size=texture_size)
                else:
                    mesh.colors = bake_vertex_colors(mesh, gs)
            else:
                mesh.colors = vcols
        mesh.vertices = mesh.vertices - 0.5
        return mesh

    def noise(self, name: str, shape: tuple, draws: Callable | None,
              gen: torch.Generator) -> torch.Tensor:
        """The named draw: `draws(name, shape)` when given, else a normal
        draw from `gen`; float32 on the device."""
        if draws is not None:
            return torch.tensor(np.asarray(draws(name, shape)), dtype=torch.float32,
                                device=self.device)
        return torch.randn(shape, generator=gen, device=self.device)

    def run(self, rgba: np.ndarray, seed: int = 1, draws: Callable | None = None,
            timer: StageTimer | None = None) -> dict:
        """Image -> mesh, Gaussians and voxels. `draws(name, shape)` gives
        the "ss" noise (1, R^3, C) and the "slat" noise (1, n_fine, C).
        `timer` gets one span per component: "get_cond",
        "sample_sparse_structure", "sample_slat", "decode" and "to_glb_mesh"
        (with its own "flexicubes_to_mesh" and "bake")."""
        self._ensure()
        c = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with self._span(timer, "get_cond"):
            cond, uncond = self.get_cond(self.preprocess(rgba))
        with self._span(timer, "sample_sparse_structure"):
            coords, valid = self.sample_sparse_structure(cond, uncond, self.noise(
                "ss", (1, c.structure.latent_res ** 3, c.structure.latent_channels), draws, gen))
        with self._span(timer, "sample_slat"):
            n_fine, _ = self.slat_buckets(coords, valid)
            slat = self.sample_slat(coords, valid, cond, uncond, self.noise(
                "slat", (1, n_fine, c.slat.latent_channels), draws, gen))
        with self._span(timer, "decode"):
            gs, mesh_out = self.decode(slat, coords, valid)
        with self._span(timer, "to_glb_mesh"):
            mesh = self.to_glb_mesh(gs, mesh_out, timer=timer)
        return {"mesh": mesh, "gaussians": gs, "coords": coords, "valid": valid, "slat": slat,
                "mesh_features": mesh_out}

    def reconstruct(self, crop_rgba: np.ndarray, label: str = "") -> Mesh:
        """Stage 6's reconstruction-backend protocol."""
        return self.run(crop_rgba)["mesh"]
