"""Distribution: logical sharding, compression, pipeline parallelism."""
from . import compression, pipeline, sharding

__all__ = ["compression", "pipeline", "sharding"]
