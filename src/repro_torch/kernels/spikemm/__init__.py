"""Event-gated spike x weight matmul (dense channel)."""
