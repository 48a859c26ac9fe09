"""LM serving: KV caches, slots and the batched engine."""
