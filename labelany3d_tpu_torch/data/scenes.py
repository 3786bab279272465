"""Scene abstraction (the reference's `src/dataset_model/`).

Counterpart of `labelany3d_tpu/data/scenes.py`: `BaseScene` holds the
fields the stages read (image_pil, image_np, depth_map, K, c2w),
`InTheWild` opens an image path (the config's `scene.type: InTheWild`), and
`get_scene(type, attrs)` is the reference's importlib factory as a
registry dict.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class BaseScene:
    """Holds one scene's image + camera state as the stages see it."""

    def __init__(self):
        self.image_pil = None
        self.image_np: np.ndarray | None = None
        self.depth_map: np.ndarray | None = None
        self.K: np.ndarray | None = None
        self.c2w: np.ndarray = np.eye(4)


class InTheWild(BaseScene):
    def __init__(self, img_path: str):
        super().__init__()
        from PIL import Image

        self.image_pil = Image.open(img_path).convert("RGB")
        self.image_np = np.asarray(self.image_pil)


class ArrayScene(BaseScene):
    """In-memory scene (synthetic tests / pre-decoded batches)."""

    def __init__(self, image: np.ndarray):
        super().__init__()
        from PIL import Image

        self.image_np = np.asarray(image)
        self.image_pil = Image.fromarray(self.image_np)


_SCENE_TYPES: dict[str, Callable[..., BaseScene]] = {
    "InTheWild": InTheWild,
    "Array": ArrayScene,
}


def register_scene_type(name: str, factory: Callable[..., BaseScene]) -> None:
    _SCENE_TYPES[name] = factory


def get_scene(scene_type: str, attributes) -> BaseScene:
    """`src/dataset_model/__init__.py:5-7`: build a scene by type name."""
    if scene_type not in _SCENE_TYPES:
        raise KeyError(f"Unknown scene type '{scene_type}'. Available: {sorted(_SCENE_TYPES)}")
    return _SCENE_TYPES[scene_type](**dict(attributes))
