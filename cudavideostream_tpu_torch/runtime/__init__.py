"""Host runtime: frame sources, TCP server/client, executor, metrics."""
