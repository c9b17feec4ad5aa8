"""Fused recurrent leaky integrate-and-fire over time."""
