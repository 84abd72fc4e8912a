"""Data pipeline: deterministic, stateless, shardable synthetic corpora."""

from repro_torch.data.synthetic import SyntheticTask, make_task

__all__ = ["SyntheticTask", "make_task"]
