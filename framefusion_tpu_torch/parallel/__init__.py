"""Sharded serving and training over the Qwen2 stack (counterpart of
``framefusion_tpu.parallel``).

Across ranks on ``torch.distributed``: ``launch.py`` starts the ranks,
``sharding.py`` holds JAX's tensor-parallel table and each rank's shard,
``collectives.py`` the reduces, gathers, sends and receives a sharded model
makes over its groups (with the backward a sharded training step needs),
``seq_shard.py`` the sequence-sharded prefill and ``workers.py`` the rank
programs of the tests and the smoke run. ``train.py`` holds the training
step on one device or over a ``(data, tensor)`` mesh, ``pipeline.py`` the
GPipe schedule over a ``(data, stage)`` mesh.
"""
