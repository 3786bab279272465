"""Models of the `fast` route: ViT backbone, MoGe, DepthPro, and their weights."""
