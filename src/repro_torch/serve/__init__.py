"""Serving: the KV store and the Lambda batch/speed layers."""
from repro_torch.serve.kvstore import KVStore
from repro_torch.serve.lambda_pipeline import (
    BatchLayer,
    SpeedLayer,
    history_requests,
    host_sigmoid,
    split_equivalence_check,
)

__all__ = ["BatchLayer", "KVStore", "SpeedLayer", "history_requests",
           "host_sigmoid", "split_equivalence_check"]
