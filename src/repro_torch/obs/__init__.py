"""Telemetry for the port: metrics registry, span tracing, exporters.

A copy of `repro.obs` (framework-free there too), kept in the port so
that it imports nothing of the JAX package.  Tracing is armed with
``REPRO_TORCH_TRACE=path.json``.
"""
from . import export, metrics, trace
from .metrics import Counter, Gauge, Histogram, Registry
from .trace import Tracer, model_span, span

__all__ = [
    "export", "metrics", "trace",
    "Counter", "Gauge", "Histogram", "Registry",
    "Tracer", "span", "model_span",
]
