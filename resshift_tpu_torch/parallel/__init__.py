"""Data parallelism: process groups, per-card replicas, DP and FSDP training."""
