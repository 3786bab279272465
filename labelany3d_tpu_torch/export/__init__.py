"""Omni3D COCO3D export (host side)."""
