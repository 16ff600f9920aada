from .tracer import DerivedGroup, scanned, trace_dim_groups  # noqa: F401
