"""Fused leaky integrate-and-fire over time."""
