"""Application-layer presets."""
