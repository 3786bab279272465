"""Device resolution, precision control, timing, logging and image IO."""
