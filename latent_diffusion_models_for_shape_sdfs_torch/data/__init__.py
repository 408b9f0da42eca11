"""Data sources: analytic SDF shapes and the per-scene sample store."""
