"""L6 — output writers, byte-identical to the reference formats.

- ``<NAME>_biomarkers.txt`` (ref: G2Vec.py:127-131): header ``GeneSymbol``
  then one gene symbol per line.
- ``<NAME>_lgroups.txt`` (ref: G2Vec.py:159-165): header
  ``GeneSymbol\\tLgroup(0:good,1:poor,2:other)`` then ``gene\\t<int>`` for
  ALL genes in global (sorted-intersection) order.
- ``<NAME>_vectors.txt`` (ref: G2Vec.py:203-215): header
  ``GeneSymbol\\tV0...V{h-1}`` then ``gene`` + ``\\t%.6f`` per dim for ALL
  genes (formatted by integer numpy arithmetic, the bytes of Python's
  ``%``, so that a table of 10^7-10^8 values takes seconds); under an
  embed split rank 0 writes every rank's slice (:func:`write_vectors_sharded`).
- ``<NAME>_stability.txt`` (the scenario engine's table,
  :func:`write_stability`): the JAX package's format byte for byte.
- ``<NAME>_inventory/`` (the query plane's binary bundle, ``--emit-
  inventory`` solo or published by the serve daemon on job completion):
  float32 ``embeddings.npy`` ``[G, H]`` + ``norms.npy`` row L2 norms +
  ``scores.npy`` ``[2, G]`` prognostic scores + ``genes.txt`` +
  ``meta.json``, sealed by a sha256 ``MANIFEST.json``, in generations
  behind a ``GENERATION`` pointer. The port's copy of
  ``g2vec_tpu/io/writers.py``'s writer: for the same arrays every array
  file is byte-identical to the JAX package's, and either package's
  reader opens the other's bundles.
"""
from __future__ import annotations

import io
import os
import shutil
from typing import Optional, Sequence

import numpy as np

#: Bundle files whose bytes must match between a solo ``--emit-inventory``
#: run and the serve daemon's publication of the same config (meta.json
#: carries run-context fields — job id, publish source — and is excluded).
INVENTORY_ARRAYS = ("embeddings.npy", "norms.npy", "scores.npy", "genes.txt")
INVENTORY_MANIFEST = "MANIFEST.json"
#: Generation pointer at the bundle ROOT: one line naming the live
#: generation subdirectory (``gen-NNNNNN``). Written tmp + os.replace
#: LAST, so the flip is the atomic commit point — a reader resolves
#: the pointer and maps entirely-old or entirely-new files, never a
#: mix. Bundles written before the generational layout have their
#: files flat in the root (no pointer) and stay readable as-is.
GENERATION_FILE = "GENERATION"
#: Top-M prognostic-score shortlist rows per group kept in
#: ``ann_scores.npy`` (int64 ``[2, M]``) — computed with the exact
#: top-k kernel at build time, so serving a k <= M biomarker query
#: from the prefix is identical to the exact answer by construction.
ANN_SCORE_TOPM = 1024


def read_generation(bundle_dir: str) -> str:
    """The live generation subdir name from ``bundle_dir``'s pointer,
    or ``""`` for a pre-generational flat bundle (files in the root)."""
    try:
        with open(os.path.join(bundle_dir, GENERATION_FILE)) as f:
            return f.read().strip()
    except OSError:
        return ""


def _next_generation(bundle_dir: str) -> int:
    """Serial for the next generation: one past the live pointer's, or
    past the highest ``gen-*`` dir present (an orphan from a crash
    between the subdir rename and the pointer flip must not be reused)."""
    serial = 0
    cur = read_generation(bundle_dir)
    if cur.startswith("gen-"):
        try:
            serial = int(cur[4:])
        except ValueError:
            serial = 0
    try:
        names = os.listdir(bundle_dir)
    except OSError:
        names = []
    for name in names:
        if name.startswith("gen-"):
            try:
                serial = max(serial, int(name[4:]))
            except ValueError:
                continue
    return serial + 1




def write_biomarkers(result_name: str, biomarkers: Sequence[str]) -> str:
    path = result_name + "_biomarkers.txt"
    with open(path, "w") as fout:
        fout.write("GeneSymbol\n")
        for gene in biomarkers:
            fout.write("%s\n" % gene)
    return path


def write_lgroups(result_name: str, lgroup_idx: np.ndarray,
                  genes: Sequence[str]) -> str:
    if len(genes) != len(lgroup_idx):
        raise ValueError(f"write_lgroups: {len(genes)} genes vs "
                         f"{len(lgroup_idx)} L-group indices")
    path = result_name + "_lgroups.txt"
    with open(path, "w") as fout:
        fout.write("GeneSymbol\tLgroup(0:good,1:poor,2:other)\n")
        for gene, group in zip(genes, lgroup_idx):
            fout.write("%s\t%d\n" % (gene, group))
    return path


#: Rows of the vectors file formatted in one numpy pass.
_VECTOR_ROWS_CHUNK = 4096
#: "00".."99" as ASCII digit pairs, read as little-endian uint16 words.
_DIGITS2 = np.array([[ord(c) for c in "%02d" % k] for k in range(100)],
                    np.uint8).view("<u2").reshape(100)


def _fixed6_block(genes: Sequence[str], vectors: np.ndarray
                  ) -> Optional[str]:
    """The vectors file's lines for ``genes`` and float32 ``vectors``: the
    text that ``gene + "\\t%.6f" * H + "\\n"`` makes, built with numpy
    instead of one Python call a value. None (the caller formats in
    Python) unless every value is finite and rounds below 10, and every
    gene name is ASCII.

    Exact: ``float64(|v|) * 1e6`` is exact for a float32 ``v`` (24 + 14
    mantissa bits), and ``np.rint`` rounds it half-even, as Python's
    ``%.6f`` rounds the exact binary value."""
    v = np.ascontiguousarray(vectors, dtype=np.float32)
    if not np.isfinite(v).all():
        return None
    q = np.rint(np.abs(v.astype(np.float64)) * 1e6)
    if q.size and q.max() >= 1e7:
        return None
    q = q.astype(np.int64)
    try:
        names = np.array([g.encode("ascii") for g in genes], dtype=bytes)
    except UnicodeEncodeError:
        return None
    rows, h = v.shape
    ip, fp = np.divmod(q, 10 ** 6)
    # Ten bytes a value, five little-endian words: tab and sign (0 when
    # positive, dropped below), integer digit and point, three digit pairs.
    cells = np.empty((rows, h, 5), np.uint16)
    cells[..., 0] = 9 | (np.signbit(v).astype(np.uint16) * 45) << 8
    cells[..., 1] = (48 + ip).astype(np.uint16) | 46 << 8
    hi, rest = np.divmod(fp, 10 ** 4)
    mid, lo = np.divmod(rest, 100)
    cells[..., 2] = _DIGITS2[hi]
    cells[..., 3] = _DIGITS2[mid]
    cells[..., 4] = _DIGITS2[lo]
    width = max(names.dtype.itemsize, 1)
    block = np.zeros((rows, width + h * 10 + 1), np.uint8)
    block[:, :width] = names.view(np.uint8).reshape(rows, width)
    block[:, width:-1] = cells.view(np.uint8).reshape(rows, h * 10)
    block[:, -1] = ord("\n")
    return block[block != 0].tobytes().decode("ascii")


def _vector_lines(genes: Sequence[str], vectors: np.ndarray):
    """The vectors file's rows for ``genes`` and float32 ``vectors``, in
    chunks of text."""
    for lo in range(0, vectors.shape[0], _VECTOR_ROWS_CHUNK):
        part = vectors[lo:lo + _VECTOR_ROWS_CHUNK]
        names = genes[lo:lo + _VECTOR_ROWS_CHUNK]
        text = _fixed6_block(names, part)
        if text is None:
            text = "".join(g + "".join("\t%.6f" % val for val in vector)
                           + "\n" for g, vector in zip(names, part))
        yield text


def _vectors_header(hidden: int) -> str:
    return "GeneSymbol" + "".join("\tV%d" % i for i in range(hidden)) + "\n"


def write_vectors(result_name: str, vectors: np.ndarray,
                  genes: Sequence[str]) -> str:
    path = result_name + "_vectors.txt"
    vectors = np.asarray(vectors, dtype=np.float32)
    if len(genes) != vectors.shape[0]:
        raise ValueError(f"write_vectors: {len(genes)} genes vs "
                         f"{vectors.shape[0]} embedding rows")
    with open(path, "w") as fout:
        fout.write(_vectors_header(vectors.shape[1]))
        for text in _vector_lines(genes, vectors):
            fout.write(text)
    return path


def write_vectors_sharded(result_name: str, vectors_local: np.ndarray,
                          genes: Sequence[str], sctx) -> str:
    """:func:`write_vectors` for a gene-range-split embedding: every rank
    publishes its ``[g_local, H]`` slice over the store, and rank 0 writes
    the slices into the file in rank order (which is gene order: the
    ranges are contiguous), holding one slice at a time, never the
    ``[G, H]`` table. The bytes are :func:`write_vectors`'s.

    COLLECTIVE over ``sctx``'s ranks: every rank calls it (the others
    publish and return). ``genes`` is the full gene list; the path is
    returned on every rank."""
    from g2vec_tpu_torch.parallel import hostcomm

    spec = sctx.spec
    path = result_name + "_vectors.txt"
    vectors_local = np.asarray(vectors_local, dtype=np.float32)
    if spec.n_ranks == 1:
        return write_vectors(result_name, vectors_local, genes)
    lo, hi = spec.gene_range()
    if vectors_local.shape[0] != hi - lo:
        raise ValueError(
            f"write_vectors_sharded: rank {spec.rank} has "
            f"{vectors_local.shape[0]} rows for gene range [{lo}, {hi})")
    buf = io.BytesIO()
    np.save(buf, vectors_local, allow_pickle=False)
    hostcomm.put_bytes_chunked(f"g2vec/xc/vectors/{spec.rank}",
                               buf.getvalue())
    if spec.rank != 0:
        return path
    with open(path, "w") as fout:
        fout.write(_vectors_header(vectors_local.shape[1]))
        for r in range(spec.n_ranks):
            if r == 0:
                part = vectors_local
            else:
                part = np.load(io.BytesIO(hostcomm.get_bytes_chunked(
                    f"g2vec/xc/vectors/{r}", deadline=sctx.deadline,
                    owner=r)), allow_pickle=False)
            rlo, rhi = spec.gene_range(r)
            if part.shape[0] != rhi - rlo:
                raise ValueError(
                    f"write_vectors_sharded: rank {r} published "
                    f"{part.shape[0]} rows for gene range [{rlo}, {rhi})")
            for text in _vector_lines(genes[rlo:rhi], part):
                fout.write(text)
    return path


def write_stability(result_name: str, scenario: str,
                    meta: Sequence, columns: Sequence[str],
                    genes: Sequence[str],
                    rows: Sequence[Sequence[str]]) -> str:
    """The scenario reducer's artifact: ``<NAME>_stability.txt``.

    ``meta`` is an ordered sequence of ``(key, value)`` pairs written as
    ``# key\tvalue`` lines; ``rows`` holds one preformatted string per
    cell (stats/reduce.py owns the number formats), so this writer only
    joins bytes.
    """
    if len(genes) != len(rows):
        raise ValueError(f"write_stability: {len(genes)} genes vs "
                         f"{len(rows)} rows")
    path = result_name + "_stability.txt"
    with open(path, "w") as fout:
        fout.write("# g2vec stability v1\tscenario=%s\n" % scenario)
        for key, value in meta:
            fout.write("# %s\t%s\n" % (key, value))
        fout.write("GeneSymbol\t" + "\t".join(columns) + "\n")
        for gene, row in zip(genes, rows):
            if len(row) != len(columns):
                raise ValueError(
                    f"write_stability: row for {gene!r} has {len(row)} "
                    f"cells for {len(columns)} columns")
            fout.write(gene + "\t" + "\t".join(row) + "\n")
    return path


def write_inventory_bundle(bundle_dir: str, embeddings: np.ndarray,
                           genes: Sequence[str],
                           scores: Optional[np.ndarray],
                           meta: dict, ann_nlist: int = 0,
                           seed_centroids: Optional[np.ndarray] = None,
                           extra_files: Optional[dict] = None
                           ) -> str:
    """Publish one query-plane bundle generation under ``bundle_dir``.

    Generation-atomic: the new contents are staged in a ``.tmp.<pid>``
    sibling, renamed to ``<bundle_dir>/gen-NNNNNN``, and COMMITTED by
    rewriting the :data:`GENERATION` pointer (tmp + ``os.replace``,
    rename-last). A concurrent reader resolves the pointer once and
    maps entirely-old or entirely-new files — never a torn mix — and
    a crash anywhere before the pointer flip leaves the prior
    generation serving untouched (the orphan subdir is swept by the
    next publish). The previous generation is kept on disk so in-flight
    readers of the old pointer still resolve; older ones are removed.
    The sha256 manifest (written before the renames, atomically itself)
    is the read-side integrity gate: serve/inventory.py refuses to map
    a generation whose manifest is missing or whose hashes mismatch.

    ``extra_files`` maps extra file names to JSON-serializable objects
    written into the generation and sha256'd into its manifest
    (``delta_``/``ann_`` prefixed files ride the LENIENT verification
    tier: corruption costs incrementality or index coverage, never
    query correctness).

    ``scores`` may be ``None`` for a partial republication from the
    durable record's text outputs (the ``[2, G]`` score matrix is not
    recoverable from them); ``meta["has_scores"]`` records which kind
    this bundle is.

    ``ann_nlist`` gates the IVF index build (ops/ann.py:resolve_nlist —
    0 auto-indexes large bundles, <0 disables, >0 forces a list count);
    when an index is built its three files are sha256'd into the SAME
    manifest as the exact arrays and ``meta["ann"]`` records the build.
    ``seed_centroids`` (the stage-5 k-means centers, when the caller
    has them) seed the coarse quantizer for free; any shape mismatch
    silently falls back to the deterministic row seeding.
    """
    import time as _time

    from g2vec_tpu_torch.utils.integrity import (sha256_file,
                                                 write_json_atomic)

    embeddings = np.asarray(embeddings, dtype=np.float32)
    if embeddings.ndim != 2 or embeddings.shape[0] != len(genes):
        raise ValueError(
            f"write_inventory_bundle: embeddings {embeddings.shape} vs "
            f"{len(genes)} genes")
    from g2vec_tpu_torch.ops import ann as ann_ops
    from g2vec_tpu_torch.ops.knn import row_norms
    from g2vec_tpu_torch.resilience.faults import fault_point

    bundle_dir = os.path.abspath(bundle_dir)
    tmp = f"{bundle_dir}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.save(os.path.join(tmp, "embeddings.npy"), embeddings,
            allow_pickle=False)
    np.save(os.path.join(tmp, "norms.npy"), row_norms(embeddings),
            allow_pickle=False)
    if scores is not None:
        scores = np.asarray(scores, dtype=np.float32)
        if scores.ndim != 2 or scores.shape[1] != embeddings.shape[0]:
            raise ValueError(
                f"write_inventory_bundle: scores {scores.shape} vs "
                f"[*, {embeddings.shape[0]}] expected")
        np.save(os.path.join(tmp, "scores.npy"), scores,
                allow_pickle=False)
    with open(os.path.join(tmp, "genes.txt"), "w") as fout:
        for gene in genes:
            fout.write("%s\n" % gene)
    nlist = ann_ops.resolve_nlist(embeddings.shape[0], ann_nlist)
    ann_meta = None
    if nlist:
        t0 = _time.perf_counter()
        centroids, postings, offsets = ann_ops.build_ivf(
            embeddings, nlist, seed_centroids=seed_centroids)
        np.save(os.path.join(tmp, "ann_centroids.npy"), centroids,
                allow_pickle=False)
        np.save(os.path.join(tmp, "ann_postings.npy"), postings,
                allow_pickle=False)
        np.save(os.path.join(tmp, "ann_offsets.npy"), offsets,
                allow_pickle=False)
        # Posting-major vector copy: the RAW float32 rows reordered so
        # a probed list's candidates are one contiguous slab (streams)
        # instead of a fancy-indexed gather (~100 ns/row of cache
        # misses). Raw — not pre-normalized — because bitwise equality
        # with the gather path requires the identical row-dot-then-
        # divide arithmetic of ops/knn.
        np.save(os.path.join(tmp, "ann_vectors.npy"),
                np.ascontiguousarray(embeddings[postings]),
                allow_pickle=False)
        score_topm = 0
        if scores is not None:
            from g2vec_tpu_torch.ops.knn import topk_scores
            score_topm = min(int(embeddings.shape[0]), ANN_SCORE_TOPM)
            short = np.stack([topk_scores(scores[r], score_topm)[0]
                              for r in range(scores.shape[0])])
            np.save(os.path.join(tmp, "ann_scores.npy"),
                    short.astype(np.int64), allow_pickle=False)
        ann_meta = {"format": ann_ops.ANN_FORMAT, "nlist": int(nlist),
                    "nprobe_default": ann_ops.DEFAULT_NPROBE,
                    "posting_major": True,
                    "score_topm": int(score_topm),
                    "seeded": bool(
                        seed_centroids is not None
                        and np.asarray(seed_centroids).ndim == 2
                        and np.asarray(seed_centroids).shape[1]
                        == embeddings.shape[1]),
                    "build_ms": round(
                        (_time.perf_counter() - t0) * 1000.0, 3)}
    for name, obj in sorted((extra_files or {}).items()):
        write_json_atomic(os.path.join(tmp, name), obj)
    meta = dict(meta, n_genes=int(embeddings.shape[0]),
                hidden=int(embeddings.shape[1]),
                has_scores=scores is not None, ann=ann_meta)
    write_json_atomic(os.path.join(tmp, "meta.json"), meta)
    files = {}
    for name in sorted(os.listdir(tmp)):
        files[name] = {"sha256": sha256_file(os.path.join(tmp, name)),
                       "bytes": os.path.getsize(os.path.join(tmp, name))}
    write_json_atomic(os.path.join(tmp, INVENTORY_MANIFEST),
                      {"format": "g2vec-inventory-v1", "files": files})
    if nlist:
        # AFTER the manifest, BEFORE the rename: a kind=corrupt here
        # publishes a bundle whose index bytes no longer match their
        # manifest hash — the torn-index drill the lenient map path
        # (serve/inventory.py) must catch and downgrade to exact.
        fault_point("ann_build",
                    path=os.path.join(tmp, "ann_postings.npy"))
    os.makedirs(bundle_dir, exist_ok=True)
    gen_name = "gen-%06d" % _next_generation(bundle_dir)
    os.rename(tmp, os.path.join(bundle_dir, gen_name))
    # Before the pointer flip: a kind=crash or sigkill here leaves the
    # new generation orphaned and the old pointer serving (the update
    # op's drill; journal recovery replays the publish). A kind=corrupt
    # flips bytes in the pointer, which the reader must refuse.
    fault_point("update_publish",
                path=os.path.join(bundle_dir, GENERATION_FILE))
    ptmp = os.path.join(bundle_dir, f".{GENERATION_FILE}.tmp.{os.getpid()}")
    with open(ptmp, "w") as f:
        f.write(gen_name + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptmp, os.path.join(bundle_dir, GENERATION_FILE))
    _gc_generations(bundle_dir, gen_name)
    return os.path.join(bundle_dir, gen_name)


def _gc_generations(bundle_dir: str, live: str) -> None:
    """Sweep everything but the live generation, its immediate
    predecessor (in-flight readers of the just-replaced pointer must
    still resolve; the no-delta byte-identity check also compares
    across the last flip), and the pointer itself. Removes legacy flat
    bundle files on the first generational publish over an old-layout
    bundle — open maps of them stay valid (POSIX unlink semantics)."""
    try:
        serial = int(live[4:])
    except ValueError:
        return
    keep = {live, "gen-%06d" % (serial - 1), GENERATION_FILE}
    for name in sorted(os.listdir(bundle_dir)):
        if name in keep:
            continue
        path = os.path.join(bundle_dir, name)
        try:
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.unlink(path)
        except OSError:
            pass
