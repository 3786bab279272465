"""Instance providers: COCONUT annotations or wild-mode segmentation.

Counterpart of `labelany3d_tpu/data/sources.py`. The stages only need
"instances for image i": decoded from COCONUT annotations (the COCO path)
or produced by the wild-mode front-end (`data/wild.py`, no labels).
`DirectoryLoader` replaces the COCONUT loader for a plain image folder.
"""

from __future__ import annotations

import os

import numpy as np

from labelany3d_tpu_torch.data.coconut import InstanceSet, read_instances
from labelany3d_tpu_torch.data.wild import WildInstanceSource, default_wild_source


class DirectoryLoader:
    """CoconutLoader-compatible loader over a folder of images (wild mode)."""

    def __init__(self, images_dir: str, extensions=(".jpg", ".jpeg", ".png")):
        from PIL import Image

        self.images_dir = images_dir
        names = sorted(f for f in os.listdir(images_dir) if f.lower().endswith(tuple(extensions)))
        self.images = []
        for i, name in enumerate(names):
            with Image.open(os.path.join(images_dir, name)) as im:
                w, h = im.size
            self.images.append({"id": i + 1, "file_name": name, "width": w, "height": h})

    def get_images(self):
        return self.images

    def get_image_by_index(self, index: int) -> dict:
        return self.images[index]

    def get_annotations(self, image_id: int) -> list:
        return []  # wild mode has no annotations

    def __len__(self) -> int:
        return len(self.images)


class CoconutInstanceProvider:
    """Instances from COCONUT annotations (the labeled COCO path)."""

    needs_image = False  # stages skip the image decode when False

    def __init__(self, loader):
        self.loader = loader

    def instances(self, info: dict, image: np.ndarray | None = None) -> InstanceSet:
        annos = self.loader.get_annotations(info["id"])
        return read_instances(annos, (info["width"], info["height"]))


class WildInstanceProvider:
    """Instances from the wild-mode segmentation stack (needs the image)."""

    needs_image = True

    def __init__(self, source: WildInstanceSource | None = None):
        self.source = source or default_wild_source()

    def instances(self, info: dict, image: np.ndarray | None = None) -> InstanceSet:
        if image is None:
            raise ValueError("wild mode needs the decoded image")
        return self.source.read_instances(image)
