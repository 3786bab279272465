"""Object-to-scene registration: orbit renderer, cameras, PnP-based placement."""
