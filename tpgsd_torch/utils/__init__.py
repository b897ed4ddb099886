"""Shared utilities: tracing, consistency checks."""

from .trace import TraceRecorder, get_tracer, trace_event, tracing_enabled

__all__ = ["TraceRecorder", "get_tracer", "trace_event", "tracing_enabled"]
