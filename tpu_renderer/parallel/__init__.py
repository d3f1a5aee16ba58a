"""Multi-chip scale-out (no reference counterpart — SURVEY §2.4: the Vulkan
renderer is strictly single-GPU). Scaling over a jax.sharding.Mesh via
shard_map + XLA collectives.
"""
