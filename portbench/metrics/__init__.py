"""Per-layer metric readers: <metric name>.py, each with read(layer) -> value or None."""
