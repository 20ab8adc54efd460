"""Training over the Qwen2 stack (counterpart of ``framefusion_tpu.parallel``).

``train.py`` holds the one-card training step: the batched forward, the
next-token loss and an AdamW step. The JAX package's mesh sharding, its
pipeline and sequence-sharded prefill run across several cards and are not
ported yet.
"""
