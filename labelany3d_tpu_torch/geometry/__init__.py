"""Geometric core of the `fast` route (float32, TF32 off)."""
