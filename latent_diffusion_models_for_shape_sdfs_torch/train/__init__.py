"""Training loops (stage 1: the auto-decoder) and stage-2 code
normalization."""
