"""Host utilities of the port (process metrics and stage timing)."""
