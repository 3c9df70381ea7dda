"""One reader per per-layer metric: ``read(record) -> float | None``."""
