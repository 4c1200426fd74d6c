"""Parallelism: process groups, per-card replicas, DP and FSDP training
(`mesh`), tensor parallelism (`tp`) and pipeline parallelism (`pp`)."""
