"""Host-side concurrency of the port: the stage-overlap scheduler, the
multi-process runtime (``distributed``, its store collectives
``hostcomm``), the ``--mesh`` context (``mesh``) and the partitioning
arithmetic of the sharded streaming run (``shard``)."""
