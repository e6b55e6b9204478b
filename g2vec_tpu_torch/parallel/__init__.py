"""Host-side concurrency of the port: the stage-overlap scheduler, and the
multi-process runtime of the sharded streaming run (``distributed``, its
store collectives ``hostcomm`` and the partitioning arithmetic
``shard``)."""
