"""Data substrate: deterministic synthetic pipeline, bucketing, prefetch
(the port of the reference's ``repro.data``)."""

from .pipeline import BucketedBatcher, DataConfig, Prefetcher, SyntheticLM

__all__ = ["BucketedBatcher", "DataConfig", "Prefetcher", "SyntheticLM"]
