"""Flash attention: online-softmax attention, causal and sliding window."""
