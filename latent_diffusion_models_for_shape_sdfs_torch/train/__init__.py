"""Training loops (stage 1: the auto-decoder)."""
