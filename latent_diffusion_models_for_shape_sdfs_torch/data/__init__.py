"""Data sources: analytic SDF shapes, the per-scene sample store, and the
device-resident sample bank."""
