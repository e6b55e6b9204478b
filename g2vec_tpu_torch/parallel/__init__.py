"""Host-side concurrency of the port: the stage-overlap scheduler."""
