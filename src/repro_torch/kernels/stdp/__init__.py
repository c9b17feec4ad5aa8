"""On-chip learning: clipped outer-product weight updates."""
