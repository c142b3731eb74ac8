"""Attack-quality telemetry of the port (``observability.quality``)."""
