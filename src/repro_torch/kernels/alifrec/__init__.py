"""Fused adaptive-threshold LIF over time, feed-forward and self-recurrent."""
