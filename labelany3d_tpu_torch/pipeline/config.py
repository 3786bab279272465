"""Config system: YAML base + dotted CLI overrides (OmegaConf-style merge).

Parity target: every reference stage does
`OmegaConf.merge(OmegaConf.load(yaml), OmegaConf.from_cli(extras))`
(`src/batch_scripts/depth.py:104-105`) over `src/configs/image.yaml`.
This module provides the same ergonomics without OmegaConf: nested-dict
config with attribute access, `a.b.c=value` CLI overrides with YAML-typed
scalars. A copy of `labelany3d_tpu/pipeline/config.py`; PyYAML is imported
only where a YAML file or override is parsed.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any


class ConfigNode(dict):
    """Dict with attribute access and recursive wrapping."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)


def _wrap(value: Any) -> Any:
    if isinstance(value, dict) and not isinstance(value, ConfigNode):
        return ConfigNode({k: _wrap(v) for k, v in value.items()})
    return value


def _merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def parse_cli_overrides(extras: list[str]) -> dict:
    """['a.b=1', 'c=true'] -> nested dict with YAML-typed values."""
    out: dict = {}
    for item in extras:
        if "=" not in item:
            raise ValueError(f"Override must be key=value, got: {item}")
        import yaml

        key, raw = item.split("=", 1)
        value = yaml.safe_load(raw) if raw != "" else None
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


DEFAULT_CONFIG: dict = {
    # Mirrors src/configs/image.yaml:1-31 semantics.
    "scene": {
        "type": "InTheWild",
        "attributes": {"img_path": None},
    },
    "run": {
        # Reference defaults are amodal_completion='our', obj_rec='trellis'
        # (src/configs/image.yaml); until converted checkpoints are
        # installed the deterministic baselines are the sane defaults —
        # flip these via config/CLI once weights exist.
        "amodal_completion": None,      # 'our' | None
        "obj_rec": "silhouette",        # 'trellis' | 'hunyuan3d' (SVRM) |
                                        # 'hunyuan3d_carve' | 'silhouette'
        "enhance": "bicubic",           # 'invsr' | 'bicubic'
        "elevation": "zero",            # 'zero123' | 'zero'
        "segmentation": "coconut",      # 'coconut' | 'entityv2' (wild mode)
        "wild_segmentation": "color",   # 'color' | 'sam'/'entityv2' (learned)
        "wild_foreground": "border",    # 'border' | 'clipseg' (wild mode)
        "wild_tagger": "constant",      # 'constant' | 'clip' (wild mode)
        "depth": "moge+depthpro",
        "bbox_method": "pca",           # 'pca' | 'minarea'
    },
    "compute": {
        "batch_size": 8,                # images per device step
        "max_instances": 16,            # padded instance slots per image
        "num_points": 512,              # per-instance point budget
        "render_size": 512,             # registration renderer resolution
        "image_height": 512,            # resolution bucket
        "image_width": 512,
        # Aspect-ratio buckets for stage 1: each image is batched at the
        # closest-aspect bucket (equal-area variants of image_height/width,
        # dims snapped to /16). [1.0] = single square bucket (default).
        "aspect_buckets": [1.0],
        "mesh": {"data": -1},          # -1 = all local devices
        "dtype": "bfloat16",
        "seed": 0,
    },
    "models": {
        "moge": {"preset": "large"},
        "depth_pro": {"preset": "large", "input_size": 768},
        "use_fakes": False,             # tests flip this on
        "tiny": False,                  # tiny model configs (CPU dry runs)
        "clipseg_path": None,           # local CIDAS/clipseg-rd64-refined snapshot
        "clip_path": None,              # local CLIP snapshot (wild tagger)
        "sam_path": None,               # local SAM .pth (wild segmenter)
        "segformer_path": None,         # local ADE20K SegFormer .pth (filter)
        "ckpt_dir": None,               # store of models/convert_cli.py (params.safetensors)
    },
}


def load_config(path: str | None = None, overrides: list[str] | None = None) -> "ConfigNode":
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    if path is not None:
        import yaml

        with open(path) as f:
            file_cfg = yaml.safe_load(f) or {}
        cfg = _merge(cfg, file_cfg)
    if overrides:
        cfg = _merge(cfg, parse_cli_overrides(overrides))
    return _wrap(cfg)


@dataclasses.dataclass
class PipelineConfig:
    """Typed view of the compute-critical knobs."""

    batch_size: int = 8
    max_instances: int = 16
    num_points: int = 512
    render_size: int = 512
    image_height: int = 512
    image_width: int = 512
    aspect_buckets: tuple = (1.0,)
    bbox_method: str = "pca"
    seed: int = 0
    use_fakes: bool = False

    def bucket_sizes(self) -> list:
        """(h, w) buckets. Single-bucket mode (the default) is exactly the
        configured size — identical to the pre-bucketing behavior. Multiple
        aspects produce equal-area variants with dims snapped to /16; an
        aspect matching the configured size maps to it verbatim."""
        if len(self.aspect_buckets) == 1:
            return [(self.image_height, self.image_width)]
        area = self.image_height * self.image_width
        cfg_aspect = self.image_width / self.image_height
        sizes = []
        for a in self.aspect_buckets:
            if abs(a - cfg_aspect) < 1e-6:
                sizes.append((self.image_height, self.image_width))
                continue
            w = max(16, int(round((area * a) ** 0.5 / 16)) * 16)
            h = max(16, int(round(w / a / 16)) * 16)
            sizes.append((h, w))
        return sizes

    def pick_bucket(self, h: int, w: int) -> tuple:
        """Closest bucket by log-aspect distance."""
        import math

        a = w / h
        return min(self.bucket_sizes(),
                   key=lambda s: abs(math.log(a) - math.log(s[1] / s[0])))

    @staticmethod
    def from_node(cfg: ConfigNode) -> "PipelineConfig":
        c = cfg.compute
        return PipelineConfig(
            batch_size=int(c.batch_size),
            max_instances=int(c.max_instances),
            num_points=int(c.num_points),
            render_size=int(c.render_size),
            image_height=int(c.image_height),
            image_width=int(c.image_width),
            aspect_buckets=tuple(float(a) for a in c.aspect_buckets),
            bbox_method=str(cfg.run.bbox_method),
            seed=int(c.seed),
            use_fakes=bool(cfg.models.use_fakes),
        )
