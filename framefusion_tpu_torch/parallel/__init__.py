"""Sharded serving and training over the Qwen2 stack (counterpart of
``framefusion_tpu.parallel``).

Serving across ranks on ``torch.distributed``: ``launch.py`` starts the
ranks, ``sharding.py`` holds JAX's tensor-parallel table and each rank's
shard, ``collectives.py`` the reduces and gathers an engine makes over its
groups, ``seq_shard.py`` the sequence-sharded prefill and ``workers.py``
the rank programs of the tests and the smoke run. ``train.py`` holds the
one-card training step; the training mesh and the pipeline schedule are
not ported yet.
"""
