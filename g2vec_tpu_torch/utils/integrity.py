"""Content-hash and atomic-write helpers (the port's copy of
``g2vec_tpu/utils/integrity.py``): the streaming trainer's shard spool
records a sha256 per shard with :func:`sha256_file`."""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def sha256_array(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def write_json_atomic(path: str, payload: dict) -> None:
    """tmp + rename, so a torn write never leaves half a JSON behind."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
