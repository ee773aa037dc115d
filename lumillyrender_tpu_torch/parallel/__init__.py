"""Data parallelism over sample batches across ranks (parallel/shard.py)."""
