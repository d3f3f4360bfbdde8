"""Inference: encode-once window scoring, cross-window averaging, greedy rounding, tracks."""
