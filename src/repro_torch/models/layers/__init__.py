"""Layer building blocks: norms, rotary embeddings, attention, FFN."""
