"""The serve daemon, the router and the query plane (the port's copy of
``g2vec_tpu/serve``): ``protocol`` (the JSONL wire format), ``client``
(with the fleet and degraded-mode helpers), ``cli`` (``python -m
g2vec_tpu_torch serve``), ``daemon``
(:class:`~g2vec_tpu_torch.serve.daemon.ServeDaemon` over one
``ResidentEngine``), ``router`` (the front door over N daemon replicas),
``inventory`` (memory-mapped bundles and the ``query``/``fquery`` ops)
and ``leader`` (the leadership lease, fence markers and epoch files).
Importing this package loads neither torch nor the daemon: the client
and the router stay light.
"""
