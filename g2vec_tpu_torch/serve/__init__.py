"""The serve daemon and the query plane (the port's copy of
``g2vec_tpu/serve``, the single daemon): ``protocol`` (the JSONL wire
format), ``client``, ``cli`` (``python -m g2vec_tpu_torch serve``),
``daemon`` (:class:`~g2vec_tpu_torch.serve.daemon.ServeDaemon` over one
``ResidentEngine``), ``inventory`` (memory-mapped bundles and the
``query``/``fquery`` ops) and ``leader`` (the fence marker and epoch
file helpers). Importing this package loads neither torch nor the
daemon: the client side stays light.
"""
