"""Memory-mapped embedding inventory — the query plane's read substrate.

The port's copy of ``g2vec_tpu/serve/inventory.py``, unchanged: each
package's catalog opens the other's bundles.

The batch plane (daemon/engine) produces embeddings; this module serves
them at interactive rates without ever holding a full ``[G, H]`` table
per query. A *bundle* is the generational directory written by
``io/writers.write_inventory_bundle``::

    <root>/<key>/
        GENERATION       pointer: one line naming the live generation
        gen-NNNNNN/
            embeddings.npy   float32 [G, H]
            norms.npy        float32 [G] precomputed row L2 norms
            scores.npy       float32 [2, G] prognostic scores (optional)
            genes.txt        one symbol per row, row order == array order
            meta.json        lane/run metadata (job_id, variant, config)
            MANIFEST.json    sha256 + byte size per file (utils/integrity)

A reader resolves the pointer ONCE at map time and reads every file
from that generation, so a concurrent republish (the ``update`` op's
atomic flip — writers.py renames the pointer last) can never hand it a
mixed old/new file set. Bundles from before the generational layout
keep their files flat in ``<key>/`` (no pointer) and map unchanged.

The daemon publishes one bundle per completed (job, variant) under
``<state>/inventory/<job_id>/<variant>/``; solo runs with
``--emit-inventory`` publish ``<result_name>_inventory/``. Both go
through the same writer, so the array files are byte-identical twins.

:class:`InventoryCatalog` rebuilds its view of the world from disk on
every listing (boot needs no replay — the bundles ARE the catalog) and
lazily memory-maps bundles behind a byte-budgeted LRU: ``np.load(...,
mmap_mode='r')`` maps the arrays without copying, the cold-path
manifest verification is the only full read a bundle ever gets, and
queries touch O(block) pages via the blocked kernels in ``ops/knn.py``.
A tampered or torn bundle raises :class:`InventoryError` with a
structured code instead of serving corrupt rows.

This module is numpy and the standard library only: it never loads
torch, and a bundle never goes whole onto the card.
"""
from __future__ import annotations

import collections
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from g2vec_tpu_torch.io.writers import (GENERATION_FILE,
                                        INVENTORY_MANIFEST, read_generation)
from g2vec_tpu_torch.ops import ann as ann_ops
from g2vec_tpu_torch.ops import knn

#: Manifest-name prefixes on the LENIENT verification tier: derived
#: data whose corruption may cost coverage (index probes, biomarker
#: shortlists, delta fingerprints) but never correctness — the exact
#: arrays stay strict.
LENIENT_PREFIXES = ("ann_", "delta_")

#: Sub-ops a ``query`` request may name (protocol vocabulary; the CLI
#: and daemon/router dispatch validate against this tuple).
QUERY_SUBOPS = ("neighbors", "topk_biomarkers", "meta", "list")

#: Retrieval modes for the ``neighbors`` sub-op: ``approx`` probes the
#: bundle's IVF index (ops/ann.py) and exact-rescores the survivors —
#: float-exact whenever the true top-k lives in the probed lists —
#: while ``exact`` is the ground-truth blocked kernel. ``approx`` is
#: the default and silently serves exactly when a bundle has no index
#: (small bundles below the auto threshold, pre-index republications).
QUERY_MODES = ("approx", "exact")

#: Federated cross-bundle sub-ops (the ``fquery`` op): ``gene_rank``
#: asks every bundle where it ranks ``gene`` in its prognostic scores;
#: ``bundle_overlap`` ranks bundles by how much their neighborhood of
#: ``gene`` overlaps a reference neighbor set.
FQUERY_SUBOPS = ("gene_rank", "bundle_overlap")


class InventoryError(Exception):
    """A structured query-plane failure: ``code`` is wire-stable
    (``not_found`` / ``torn`` / ``tampered`` / ``bad_query`` /
    ``scores_unavailable``), ``detail`` is for humans."""

    def __init__(self, code: str, detail: str):
        super().__init__(f"{code}: {detail}")
        self.code = code
        self.detail = detail


class _Bundle:
    """One mapped bundle: mmap'd arrays + the eager gene index.

    Immutable after construction — the catalog lock only guards the
    LRU bookkeeping, never per-bundle state.
    """

    def __init__(self, path: str):
        # Resolve the generation pointer ONCE; every file below reads
        # from the resolved root, so a republish flipping the pointer
        # mid-map cannot hand this bundle a mixed file set.
        generation = read_generation(path)
        if generation and (not generation.startswith("gen-")
                           or "/" in generation or ".." in generation):
            raise InventoryError(
                "torn", f"{path}: corrupt {GENERATION_FILE} pointer "
                        f"({generation!r})")
        root = os.path.join(path, generation) if generation else path
        man_path = os.path.join(root, INVENTORY_MANIFEST)
        try:
            with open(man_path) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise InventoryError(
                "torn", f"{root}: no {INVENTORY_MANIFEST} (interrupted "
                f"publication or not a bundle)")
        except ValueError as e:
            raise InventoryError("torn", f"{man_path}: unparseable ({e})")
        from g2vec_tpu_torch.utils.integrity import sha256_file

        files = manifest.get("files", {})
        # Verification is two-tier: the EXACT arrays are load-bearing
        # (a mismatch refuses the whole bundle, as ever), while the
        # ``ann_*`` index files degrade — a torn/tampered index is
        # refused AT MAP TIME with a structured warning and the bundle
        # still serves through the exact path. A corrupted index can
        # therefore never change an answer, only slow one down.
        bad: Dict[str, dict] = {}
        for name, want in sorted(files.items()):
            fp = os.path.join(root, name)
            lenient = name.startswith(LENIENT_PREFIXES)
            if not os.path.exists(fp):
                if lenient:
                    bad.setdefault(name.split("_", 1)[0], {
                        "code": "torn",
                        "detail": f"{root}: manifest names {name} but "
                                  f"it is missing"})
                    continue
                raise InventoryError("torn", f"{root}: manifest names "
                                             f"{name} but it is missing")
            if os.path.getsize(fp) != want.get("bytes"):
                if lenient:
                    bad.setdefault(name.split("_", 1)[0], {
                        "code": "tampered",
                        "detail": f"{fp}: {os.path.getsize(fp)} bytes, "
                                  f"manifest says {want.get('bytes')}"})
                    continue
                raise InventoryError(
                    "tampered", f"{fp}: {os.path.getsize(fp)} bytes, "
                                f"manifest says {want.get('bytes')}")
            if sha256_file(fp) != want.get("sha256"):
                if lenient:
                    bad.setdefault(name.split("_", 1)[0], {
                        "code": "tampered",
                        "detail": f"{fp}: sha256 mismatch vs manifest"})
                    continue
                raise InventoryError("tampered", f"{fp}: sha256 mismatch "
                                                 f"vs manifest")
        ann_bad = bad.get("ann")
        for required in ("embeddings.npy", "norms.npy", "genes.txt",
                         "meta.json"):
            if required not in files:
                raise InventoryError(
                    "torn", f"{root}: manifest lacks {required}")
        self.path = path
        self.root = root
        #: The live generation name mapped at construction ("" for a
        #: pre-generational flat bundle). Part of the QueryCache key,
        #: so a republish structurally invalidates cached answers.
        self.generation = generation
        self.embeddings = np.load(os.path.join(root, "embeddings.npy"),
                                  mmap_mode="r", allow_pickle=False)
        self.norms = np.load(os.path.join(root, "norms.npy"),
                             mmap_mode="r", allow_pickle=False)
        self.scores = None
        if "scores.npy" in files:
            self.scores = np.load(os.path.join(root, "scores.npy"),
                                  mmap_mode="r", allow_pickle=False)
        with open(os.path.join(root, "genes.txt")) as f:
            self.genes: List[str] = [ln.rstrip("\n") for ln in f]
        with open(os.path.join(root, "meta.json")) as f:
            self.meta = json.load(f)
        if self.embeddings.ndim != 2 or \
                self.embeddings.shape[0] != len(self.genes):
            raise InventoryError(
                "tampered", f"{root}: embeddings {self.embeddings.shape} "
                            f"vs {len(self.genes)} genes")
        self.gene_index: Dict[str, int] = {
            g: i for i, g in enumerate(self.genes)}
        #: IVF index (ops/ann.py), or None with ``ann_error`` carrying
        #: the structured refusal when index files exist but failed
        #: verification or shape sanity. Both None = bundle simply has
        #: no index (below the auto threshold, or ann disabled).
        self.ann = None
        self.ann_error: Optional[dict] = None
        #: int64 [2, M] exact-prefix biomarker shortlist (ann_scores.npy)
        #: or None; serves approx ``topk_biomarkers`` for k <= M with
        #: answers identical to the exact kernel by construction.
        self.ann_scores = None
        ann_names = [n for n in files if n.startswith("ann_")]
        if ann_bad is not None:
            self.ann_error = ann_bad
        elif ann_names:
            try:
                missing = [n for n in ann_ops.ANN_FILES
                           if n not in files]
                if missing:
                    raise ValueError(f"manifest lacks {missing}")
                pvecs = None
                if "ann_vectors.npy" in files:
                    pvecs = np.load(
                        os.path.join(root, "ann_vectors.npy"),
                        mmap_mode="r", allow_pickle=False)
                self.ann = ann_ops.IVFIndex(
                    np.load(os.path.join(root, "ann_centroids.npy"),
                            mmap_mode="r", allow_pickle=False),
                    np.load(os.path.join(root, "ann_postings.npy"),
                            mmap_mode="r", allow_pickle=False),
                    np.load(os.path.join(root, "ann_offsets.npy"),
                            mmap_mode="r", allow_pickle=False),
                    n_rows=len(self.genes),
                    hidden=int(self.embeddings.shape[1]),
                    pvecs=pvecs)
                if "ann_scores.npy" in files and self.scores is not None:
                    short = np.load(
                        os.path.join(root, "ann_scores.npy"),
                        mmap_mode="r", allow_pickle=False)
                    if short.ndim != 2 \
                            or short.shape[0] != self.scores.shape[0] \
                            or short.shape[1] > len(self.genes):
                        raise ValueError(
                            f"ann_scores {short.shape} vs "
                            f"[{self.scores.shape[0]}, "
                            f"<= {len(self.genes)}]")
                    self.ann_scores = short
            except (OSError, ValueError) as e:
                self.ann = None
                self.ann_scores = None
                self.ann_error = {
                    "code": "tampered",
                    "detail": f"{root}: ann index refused ({e})"}
        #: delta_fingerprints.json payload for the update plane's
        #: owner-range diff, or None (absent / failed the lenient
        #: verification tier — incrementality degrades to a full
        #: re-walk, never a wrong answer).
        self.fingerprints = None
        if "delta_fingerprints.json" in files and "delta" not in bad:
            try:
                with open(os.path.join(
                        root, "delta_fingerprints.json")) as f:
                    self.fingerprints = json.load(f)
            except (OSError, ValueError):
                self.fingerprints = None
        #: mapped-budget charge: the npy payloads (the mmap'd set).
        self.nbytes = sum(int(w.get("bytes", 0))
                          for n, w in files.items() if n.endswith(".npy"))


def _is_bundle(path: str) -> bool:
    """A directory is a bundle if it carries a generation pointer
    (generational layout) or a root manifest (pre-generational flat
    layout)."""
    return os.path.exists(os.path.join(path, GENERATION_FILE)) or \
        os.path.exists(os.path.join(path, INVENTORY_MANIFEST))


def scan_bundles(roots: Sequence[str]) -> Dict[str, str]:
    """key -> bundle dir, rebuilt from disk (depth <= 2 under each root:
    ``<job_id>/<variant>/`` for served bundles, ``<name>_inventory/``
    for solo ones). First root wins on key collision."""
    found: Dict[str, str] = {}
    for root in roots:
        if not os.path.isdir(root):
            continue
        for d1 in sorted(os.listdir(root)):
            p1 = os.path.join(root, d1)
            if not os.path.isdir(p1) or d1.startswith("."):
                continue
            if _is_bundle(p1):
                found.setdefault(d1, p1)
                continue
            for d2 in sorted(os.listdir(p1)):
                p2 = os.path.join(p1, d2)
                if os.path.isdir(p2) and not d2.startswith(".") and \
                        not d2.startswith("gen-") and _is_bundle(p2):
                    found.setdefault(f"{d1}/{d2}", p2)
    return found


def resolve_bundle_key(known: Dict[str, str], job_id: str, variant) \
        -> Tuple[Optional[str], Optional[dict]]:
    """Map (job_id, variant?) onto one key of ``known`` (a
    :func:`scan_bundles` result), or a structured error event. A
    depth-1 key (a solo ``--emit-inventory`` bundle) matches ``job_id``
    directly; served bundles live at ``<job_id>/<variant>`` and an
    omitted variant resolves only when the job has exactly one. Shared
    by the daemon and the router so both address bundles identically."""
    if variant:
        key = f"{job_id}/{variant}"
        if key in known:
            return key, None
        return None, {
            "event": "error", "error": "not_found",
            "job_id": job_id, "detail": f"no bundle {key!r}",
            "variants": sorted(k.split("/", 1)[1] for k in known
                               if k.startswith(job_id + "/"))}
    if job_id in known:
        return job_id, None
    cands = sorted(k for k in known if k.startswith(job_id + "/"))
    if len(cands) == 1:
        return cands[0], None
    if not cands:
        return None, {"event": "error", "error": "not_found",
                      "job_id": job_id,
                      "detail": f"no bundle for job {job_id!r}"}
    return None, {
        "event": "error", "error": "ambiguous_variant",
        "job_id": job_id,
        "detail": "job has several variants; pass 'variant'",
        "variants": [c.split("/", 1)[1] for c in cands]}


class InventoryCatalog:
    """Byte-budgeted LRU of memory-mapped bundles over N disk roots.

    ``get`` maps lazily (cold path pays one manifest verification —
    the only full read) and evicts least-recently-used bundles until
    the mapped set fits ``budget_bytes`` again. All LRU state is
    guarded by one lock; the load itself also runs under it, which
    serializes cold maps — acceptable because the warm path is a dict
    hit and the bench pins cold-vs-warm separately.
    """

    def __init__(self, roots: Sequence[str], budget_bytes: int):
        self.roots = [os.path.abspath(r) for r in roots]
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        #: key -> _Bundle in LRU order (last = most recent).
        # guarded-by: _lock
        self._mapped: "collections.OrderedDict[str, _Bundle]" = \
            collections.OrderedDict()
        self._bytes_mapped = 0      # guarded-by: _lock
        self._evictions = 0         # guarded-by: _lock
        self._map_errors = 0        # guarded-by: _lock
        self._cold_maps = 0         # guarded-by: _lock

    def get(self, key: str) -> _Bundle:
        with self._lock:
            hit = self._mapped.get(key)
            if hit is not None:
                self._mapped.move_to_end(key)
                return hit
            path = scan_bundles(self.roots).get(key)
            if path is None:
                raise InventoryError(
                    "not_found", f"no bundle {key!r} under "
                                 f"{self.roots} (known: "
                                 f"{sorted(scan_bundles(self.roots))[:8]})")
            try:
                bundle = _Bundle(path)
            except InventoryError:
                self._map_errors += 1
                raise
            self._mapped[key] = bundle
            self._bytes_mapped += bundle.nbytes
            self._cold_maps += 1
            while self._bytes_mapped > self.budget_bytes and \
                    len(self._mapped) > 1:
                _, old = self._mapped.popitem(last=False)
                self._bytes_mapped -= old.nbytes
                self._evictions += 1
            return bundle

    def invalidate(self, key: str) -> None:
        with self._lock:
            old = self._mapped.pop(key, None)
            if old is not None:
                self._bytes_mapped -= old.nbytes

    def generation(self, key: str) -> str:
        """The generation the next :func:`run_query` over ``key`` will
        answer from: the already-mapped bundle's pointer when cached —
        the cached arrays ARE the answer source, and keying the
        QueryCache by the on-disk pointer instead could label an
        old-array answer with the new generation inside the
        flip→invalidate window — else the on-disk pointer. Unknown or
        flat bundles read as ``""`` (their queries fail or key
        generation-lessly, both safe)."""
        with self._lock:
            hit = self._mapped.get(key)
            if hit is not None:
                return hit.generation
        path = scan_bundles(self.roots).get(key)
        return read_generation(path) if path else ""

    def listing(self) -> List[dict]:
        """Catalog view straight from disk (cheap: meta.json only,
        nothing is mapped or verified)."""
        out = []
        for key, path in sorted(scan_bundles(self.roots).items()):
            entry = {"bundle": key}
            gen = read_generation(path)
            try:
                with open(os.path.join(path, gen, "meta.json")) as f:
                    meta = json.load(f)
                entry.update(
                    n_genes=meta.get("n_genes"), hidden=meta.get("hidden"),
                    has_scores=meta.get("has_scores"),
                    ann=bool(meta.get("ann")),
                    generation=gen or None)
            except (OSError, ValueError):
                entry["torn"] = True
            out.append(entry)
        return out

    def stats(self) -> dict:
        cataloged = len(scan_bundles(self.roots))
        with self._lock:
            return {"bundles_cataloged": cataloged,
                    "bundles_mapped": len(self._mapped),
                    "bytes_mapped": self._bytes_mapped,
                    "budget_bytes": self.budget_bytes,
                    "cold_maps": self._cold_maps,
                    "evictions": self._evictions,
                    "map_errors": self._map_errors}


class QueryCache:
    """Small keyed LRU over fully-rendered query results.

    Keys are ``(bundle, sub-op, args)`` strings; values are the exact
    JSON-able response dicts. Entry-count bounded (results are tiny:
    k genes + k floats), byte budgets stay the catalog's concern.
    """

    def __init__(self, capacity: int = 128):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        #: key -> response dict, LRU order.
        # guarded-by: _lock
        self._entries: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._hits = 0      # guarded-by: _lock
        self._misses = 0    # guarded-by: _lock

    def get_or_put(self, key: str, compute) -> Tuple[dict, bool]:
        """One critical section around lookup+insert would hold the
        lock across ``compute`` (a blocked matmul), so this is
        deliberately lookup -> compute -> insert; two racing misses
        both compute and the second insert wins — idempotent, queries
        are pure reads."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self._hits += 1
                return hit, True
            self._misses += 1
        value = compute()
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return value, False

    def invalidate_bundle(self, bundle_key: str) -> None:
        """Drop every cached result for one bundle (republication)."""
        with self._lock:
            for k in [k for k in self._entries
                      if k.startswith(bundle_key + "\x00")]:
                del self._entries[k]

    def stats(self) -> dict:
        with self._lock:
            total = self._hits + self._misses
            return {"entries": len(self._entries),
                    "capacity": self.capacity,
                    "hits": self._hits, "misses": self._misses,
                    "hit_rate": round(self._hits / total, 4)
                    if total else None}


def cache_key(bundle: str, q: str, gene: Optional[str], k: int,
              mode: str = "exact", nprobe: int = 0,
              generation: str = "") -> str:
    """The QueryCache key. ``mode``/``nprobe`` are part of it so an
    approx result can never be served for an exact request (or for a
    different probe width) of the same (bundle, q, gene, k).
    ``generation`` is the bundle's live generation pointer, read at
    request time: a republish flips the pointer, which changes every
    key, so a cached pre-flip answer is STRUCTURALLY unreachable even
    if the explicit ``invalidate_bundle`` call were lost (pinned by
    tests/test_update.py)."""
    return "\x00".join((bundle, q, gene or "", str(int(k)),
                        mode, str(int(nprobe)), generation))


def run_query(catalog: InventoryCatalog, q: str, bundle_key: str,
              gene: Optional[str] = None, k: int = 10,
              block_rows: int = 8192, mode: str = "approx",
              nprobe: int = 0) -> dict:
    """Evaluate one ``neighbors`` / ``topk_biomarkers`` / ``meta``
    sub-op against the catalog (``list`` is :meth:`InventoryCatalog.
    listing` — it takes no bundle). Shared verbatim by the daemon and
    the router's failover read path so both answer identically.

    ``mode`` steers the ``neighbors`` sub-op only (the other sub-ops
    are always exact): ``approx`` probes the bundle's IVF index and
    exact-rescores survivors; ``exact`` is the ground-truth kernel.
    The response's ``recall_mode`` says how the answer was actually
    produced — ``approx``, ``exact``, or ``exact_fallback`` (an index
    was expected but refused at map time; ``ann_warning`` carries the
    structured refusal).
    """
    if q not in ("neighbors", "topk_biomarkers", "meta"):
        raise InventoryError("bad_query", f"unknown sub-op {q!r}; "
                                          f"expected one of {QUERY_SUBOPS}")
    if mode not in QUERY_MODES:
        raise InventoryError("bad_query", f"unknown mode {mode!r}; "
                                          f"expected one of {QUERY_MODES}")
    k = int(k)
    if q != "meta" and not (1 <= k <= 10000):
        raise InventoryError("bad_query", f"k must be in [1, 10000], "
                                          f"got {k}")
    nprobe = int(nprobe)
    if not (0 <= nprobe <= 10000):
        raise InventoryError("bad_query", f"nprobe must be in "
                                          f"[0, 10000], got {nprobe}")
    b = catalog.get(bundle_key)
    if q == "meta":
        return {"bundle": bundle_key, "meta": b.meta,
                "generation": b.generation,
                "mapped_bytes": b.nbytes, "n_genes": len(b.genes),
                "hidden": int(b.embeddings.shape[1])}
    if q == "neighbors":
        if not gene:
            raise InventoryError("bad_query",
                                 "neighbors needs a 'gene' symbol")
        gi = b.gene_index.get(gene)
        if gi is None:
            raise InventoryError("bad_query",
                                 f"gene {gene!r} not in bundle "
                                 f"{bundle_key!r}")
        qvec = np.asarray(b.embeddings[gi], dtype=np.float32)
        if mode == "approx" and b.ann is not None:
            eff = nprobe or ann_ops.DEFAULT_NPROBE
            idx, sims, ncand = ann_ops.ivf_topk(
                b.embeddings, b.norms, b.ann, qvec, k, nprobe=eff,
                exclude=gi, block_rows=block_rows)
            return {"bundle": bundle_key, "gene": gene, "k": k,
                    "generation": b.generation,
                    "neighbors": [b.genes[i] for i in idx],
                    "sims": [float(s) for s in sims],
                    "mode": "approx", "recall_mode": "approx",
                    "storage": "posting_major"
                    if b.ann.pvecs is not None else "gather",
                    "nprobe": int(min(max(eff, 1), b.ann.nlist)),
                    "nlist": b.ann.nlist, "candidates": ncand}
        idx, sims = knn.cosine_topk(b.embeddings, b.norms, qvec, k,
                                    exclude=gi, block_rows=block_rows)
        out = {"bundle": bundle_key, "gene": gene, "k": k,
               "generation": b.generation,
               "neighbors": [b.genes[i] for i in idx],
               "sims": [float(s) for s in sims],
               "mode": mode, "recall_mode": "exact"}
        if mode == "approx" and b.ann_error is not None:
            out["recall_mode"] = "exact_fallback"
            out["ann_warning"] = b.ann_error
        return out
    # topk_biomarkers
    if b.scores is None:
        raise InventoryError(
            "scores_unavailable",
            f"bundle {bundle_key!r} was republished from the durable "
            f"record's text outputs, which do not carry the [2, G] "
            f"score matrix — re-run the job to restore it")
    out = {"bundle": bundle_key, "k": k, "generation": b.generation}
    short = b.ann_scores
    if mode == "approx" and short is not None \
            and k <= int(short.shape[1]):
        # Shortlist prefix: ann_scores rows are the exact kernel's own
        # top-M order (computed at build time), and _topk_desc's
        # deterministic tie rule makes top-k a PREFIX of top-M — so
        # this answer is identical to the exact path, k row reads
        # instead of a [G] scan.
        out["recall_mode"] = "approx"
        out["shortlist_m"] = int(short.shape[1])
        for row, group in enumerate(("good", "poor")):
            idx = np.asarray(short[row, :k], dtype=np.int64)
            sc = np.asarray(b.scores[row], dtype=np.float32)[idx]
            out[group] = {"genes": [b.genes[i] for i in idx],
                          "scores": [float(s) for s in sc]}
        return out
    out["recall_mode"] = "exact"
    if mode == "approx" and b.ann_error is not None:
        out["recall_mode"] = "exact_fallback"
        out["ann_warning"] = b.ann_error
    for row, group in enumerate(("good", "poor")):
        idx, sc = knn.topk_scores(np.asarray(b.scores[row],
                                             dtype=np.float32), k)
        out[group] = {"genes": [b.genes[i] for i in idx],
                      "scores": [float(s) for s in sc]}
    return out


def run_fquery(catalog: InventoryCatalog, fq: str, gene: str,
               k: int = 50, mode: str = "approx", nprobe: int = 0,
               ref_genes: Optional[Sequence[str]] = None,
               block_rows: int = 8192) -> List[dict]:
    """Evaluate one federated sub-op against EVERY bundle the catalog
    can see, returning one partial dict per bundle — never aborting on
    a bad bundle (a torn/tampered/score-less bundle contributes a
    structured per-bundle ``error`` instead). The daemon runs this over
    its own inventory; the router runs it over a dead replica's shared
    state dir, so both produce merge-compatible partials.

    ``gene_rank``: per bundle, the 1-based rank of ``gene`` in each of
    the good/poor prognostic score rows (ties by ascending row index —
    the same order :func:`ops.knn.topk_scores` would surface them) and
    whether that lands in the top ``k``. ``bundle_overlap``: per bundle
    containing ``gene``, the fraction of ``ref_genes`` (the reference
    neighbor set) found in that bundle's own ``k`` nearest neighbors of
    ``gene`` — approx/exact per ``mode``, attributed via
    ``recall_mode``.
    """
    if fq not in FQUERY_SUBOPS:
        raise InventoryError(
            "bad_query", f"unknown fquery sub-op {fq!r}; expected one "
                         f"of {FQUERY_SUBOPS}")
    if not gene:
        raise InventoryError("bad_query", "fquery needs a 'gene' symbol")
    k = int(k)
    if not (1 <= k <= 10000):
        raise InventoryError("bad_query", f"k must be in [1, 10000], "
                                          f"got {k}")
    ref = None
    if fq == "bundle_overlap":
        if not ref_genes:
            raise InventoryError(
                "bad_query", "bundle_overlap needs 'ref_genes' (or a "
                             "reference 'job_id' the daemon/router "
                             "resolves into one)")
        ref = set(ref_genes)
    out: List[dict] = []
    for key in sorted(scan_bundles(catalog.roots)):
        part: dict = {"bundle": key}
        try:
            b = catalog.get(key)
        except InventoryError as e:
            part["error"] = e.code
            out.append(part)
            continue
        gi = b.gene_index.get(gene)
        if gi is None:
            part["present"] = False
            out.append(part)
            continue
        part["present"] = True
        if fq == "gene_rank":
            if b.scores is None:
                part["error"] = "scores_unavailable"
            else:
                for row, group in enumerate(("good", "poor")):
                    s = np.asarray(b.scores[row], dtype=np.float32)
                    sv = s[gi]
                    rank = int(1 + np.count_nonzero(s > sv)
                               + np.count_nonzero(s[:gi] == sv))
                    part[group] = {"rank": rank, "in_top_k": rank <= k}
        else:
            resp = run_query(catalog, "neighbors", key, gene=gene, k=k,
                             block_rows=block_rows, mode=mode,
                             nprobe=nprobe)
            shared = len(set(resp["neighbors"]) & ref)
            part["overlap"] = round(shared / max(len(ref), 1), 6)
            part["shared"] = shared
            part["recall_mode"] = resp.get("recall_mode", "exact")
        out.append(part)
    return out


def merge_fquery(fq: str, partials: Sequence[dict]) -> List[dict]:
    """Merge scatter-gathered per-bundle partials into one ranked list.

    Dedupe is first-wins by bundle key (callers put alive-owner answers
    before failover reads, so a live replica always outranks a disk
    read of the same bundle). Ordering: ``gene_rank`` sorts by best
    (lowest) rank across the good/poor groups; ``bundle_overlap`` by
    overlap descending; bundles without a score (absent gene,
    per-bundle errors) sort after scored ones; ties break by bundle
    key so the merged order is deterministic across runs.
    """
    seen: Dict[str, dict] = {}
    for p in partials:
        key = str(p.get("bundle"))
        if key not in seen:
            seen[key] = p

    def sort_key(p: dict):
        if fq == "gene_rank":
            ranks = [p[g]["rank"] for g in ("good", "poor")
                     if isinstance(p.get(g), dict)]
            return (0 if ranks else 1,
                    min(ranks) if ranks else 1 << 30,
                    str(p.get("bundle")))
        ov = p.get("overlap")
        return (0 if ov is not None else 1, -(ov or 0.0),
                str(p.get("bundle")))

    return sorted(seen.values(), key=sort_key)


def read_vectors_txt(path: str) -> Tuple[List[str], np.ndarray]:
    """Parse a ``<NAME>_vectors.txt`` output back into (genes,
    float32 [G, H]) — the lazy-republish source when a bundle is lost
    or tampered but the durable record's text outputs survive."""
    genes: List[str] = []
    rows: List[List[float]] = []
    with open(path) as f:
        header = f.readline()
        if not header.startswith("GeneSymbol"):
            raise ValueError(f"{path}: not a vectors file")
        for ln in f:
            parts = ln.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            genes.append(parts[0])
            rows.append([float(x) for x in parts[1:]])
    return genes, np.asarray(rows, dtype=np.float32)
