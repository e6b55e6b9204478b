"""Host-side utilities of the port: the metrics stream, the stage timer
and the content-hash helpers."""
