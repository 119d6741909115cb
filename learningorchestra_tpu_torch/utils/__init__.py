"""Cross-cutting utilities: profiling, op timing, tracing, logging."""
