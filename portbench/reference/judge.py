"""Judge one run's outputs against the plain reference.

The program's outputs come in as a :class:`reference.plain.RunOutput`
(plain arrays and the bytes of its three files). The reference works
stage 3 out again from the inputs and compares the rows. For stages 4-6
it follows the program stage by stage from the program's own outputs,
each stage's input checked by the stage before: it trains from the
program's rows (held to its own by ``rows``) for as many updates as the
program made; it runs its own k-means on the program's embeddings with
the run's k-means seed; it checks the program's L-groups against its
centres and the clusters' naming by the gene votes; it scores from the
program's embeddings and L-groups. Each returns numbers, each held to a
limit of the cell's (``limits/<cell>.json``):

- ``rows``: the share of integrated rows (with their group label) in one
  set and not in the other, over the reference's count.
- ``loss``: the widest relative gap of an update's training loss (the
  first at the init: the packed forward; the next after an update).
- ``flips``: the share of the embedding elements whose change the
  reference finds clear (``plain.train``'s ``clear``: each kept update's
  gradient above four times the rounding that bfloat16 products put into
  it, with one sign) that the program's kept embeddings changed the
  other way, or not at all. Elements whose gradient is nought to the
  configuration's rounding are left out by that rule, as a leaf of zero
  gradient would be.
- ``kmeans``: the relative gap of the program's inertia (its embeddings
  to the nearest of its centres) from the reference's k-means of the same
  embeddings and seed (``kmeans_gaps``).

Reported beside them (``detail``) and not held to a limit, because sound
and control runs read them alike (PERF.md): the accuracies after each
update, the embeddings' distance from the reference's, and the widest
distance of a program centre from the reference's centre of the same
draw (``centres``: on embeddings one update from their init, sound runs
end on other Lloyd fixed points than the float64 reference in about half
of the seeds, at nearly the same inertia).
- ``score``: the widest gap of a gene score within its L-group.
- ``exact``: the number of exact checks that failed: gene order, sample
  and edge counts, the stop at the program's first accuracy dip and at
  the reference's (``stop_checks``), each gene in the L-group of its
  nearest centre, the clusters' naming by the gene votes, each group's
  biomarkers a top N of the reference's scores, and the three files'
  bytes. A gene within ``TIE`` of two centres, or a score within ``TIE``
  of the cut, may go either way.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from reference import plain, text

#: Relative band within which two distances, or a score and the top-N
#: cut, count as tied (float32 sums of the program against float64).
TIE = 1e-5

NUMBERS = ("rows", "loss", "flips", "kmeans", "score", "exact")


def _row_set(rows: np.ndarray, labels: np.ndarray) -> set:
    return {(int(l), rows[i].tobytes()) for i, l in enumerate(labels)}


def rows_gap(prog_rows, prog_labels, ref_rows, ref_labels) -> float:
    a = _row_set(prog_rows, prog_labels)
    b = _row_set(ref_rows, ref_labels)
    return len(a ^ b) / max(len(b), 1)


def first_dip(acc: List[float]) -> Optional[int]:
    """The first update whose validation accuracy is strictly below the
    one before it (0-based), or None."""
    return next((u for u in range(1, len(acc)) if acc[u] < acc[u - 1]),
                None)


def stop_checks(out: plain.RunOutput, ref_acc: List[float], cap: int,
                n_val: int) -> List[str]:
    """The program's stop against its own accuracies (``stop``: the first
    dip ends training and keeps the weights before it, or the cap) and
    against the reference's first-dip stop over the reference's own split
    and accuracies for the same updates (``stop-ref``). Where the two
    stops differ, the first update at which their dip decisions differ
    may go either way if the reference's accuracy moved there by at most
    one validation row: a row whose logit lies within rounding of the
    threshold."""
    acc, n = out.acc_val, len(out.losses)
    if len(acc) != n or n < 1:
        return ["stop"]
    failed = []
    dip = first_dip(acc)
    if (dip != n - 1 or out.stop_epoch != n - 2) if dip is not None \
            else (n != cap or out.stop_epoch != n - 1):
        failed.append("stop")
    row = 1.0 / max(n_val, 1)
    for u in range(1, n):
        ref_dips = ref_acc[u] < ref_acc[u - 1]
        if ref_dips != (acc[u] < acc[u - 1]):
            if abs(ref_acc[u] - ref_acc[u - 1]) > row * (1 + 1e-6):
                failed.append("stop-ref")
            break
        if ref_dips:
            break
    else:
        if dip is None and n < cap:
            failed.append("stop-ref")
    return failed


def kmeans_checks(w: np.ndarray, centres: np.ndarray, lgroups: np.ndarray,
                  votes: np.ndarray):
    """(genes in the wrong L-group for their nearest centre; 0/1 whether
    the clusters' names break the voting rule). A gene within ``TIE`` of
    two centres may sit in either."""
    w = np.asarray(w, np.float64)
    c = np.asarray(centres, np.float64)
    d2 = plain.sq_dists(w, c)
    order = np.argsort(d2, axis=1)
    near = order[:, 0]
    first = d2[np.arange(w.shape[0]), near]
    second = d2[np.arange(w.shape[0]), order[:, 1]]
    scale = (w * w).sum(axis=1) + (c * c).sum(axis=1).max()
    clear = second - first > TIE * scale
    k = c.shape[0]
    names = np.full(k, -1)
    bad = 0
    for j in range(k):
        members = lgroups[clear & (near == j)]
        if members.size:
            vals, cnt = np.unique(members, return_counts=True)
            names[j] = vals[np.argmax(cnt)]
            bad += int((members != names[j]).sum())
    named = sorted(names.tolist()) == list(range(k))
    naming_bad = int(not named or not np.array_equal(
                         plain.name_clusters(near, votes, k), names))
    return bad, naming_bad


def kmeans_gaps(w: np.ndarray, centres: np.ndarray, run: Dict,
                kmeans_seed: int, device) -> Tuple[float, float]:
    """The program's clustering against the reference's k-means of the
    same embeddings and seed (``plain.kmeans``, float64): (the relative
    gap of the program's inertia, the sum over genes of the squared
    distance to the nearest of its centres, from the reference's; the
    widest distance of a program centre from the reference's centre of
    the same draw, over the embeddings' root-mean-square norm)."""
    w64 = np.asarray(w, np.float64)
    c = np.asarray(centres, np.float64)
    _, c_ref, inertia_ref = plain.kmeans(
        w64, run["n_lgroups"], run["kmeans_iters"], kmeans_seed,
        device=device)
    inertia = float(plain.sq_dists(w64, c).min(axis=1).sum())
    rms = np.sqrt((w64 * w64).sum(axis=1).mean())
    centre = float(np.linalg.norm(c - c_ref, axis=1).max()
                   / max(rms, 1e-30))
    return abs(inertia - inertia_ref) / max(inertia_ref, 1e-300), centre


def biomarker_violations(s_ref: np.ndarray, lgroups: np.ndarray,
                         genes: np.ndarray, picked: List[str],
                         n: int) -> int:
    """Genes picked though clearly below a group's top-N cut, or left out
    though clearly above it, by the reference's scores."""
    picked_set = set(picked)
    bad = 0
    for g in (0, 1):
        idx = np.flatnonzero(lgroups == g)
        if idx.size == 0:
            continue
        s = s_ref[g][idx]
        cut = np.sort(s)[::-1][min(n, idx.size) - 1]
        inside = np.array([genes[i] in picked_set for i in idx])
        bad += int((inside & (s < cut - TIE)).sum())
        bad += int((~inside & (s > cut + TIE)).sum())
        bad += int(inside.sum() != min(n, idx.size))
    return bad


def judge_run(out: plain.RunOutput, graph: plain.Graph, run: Dict,
              train_seed: int, kmeans_seed: int, device,
              ref_stage3) -> Dict:
    """Numbers and failed exact checks for one run (or lane); ``ref_stage3``
    is ``plain.stage3``'s result for the run's walk seed."""
    failed: List[str] = []
    ref_rows, ref_labels, _ = ref_stage3
    g = graph.genes.size
    nums = {"rows": rows_gap(out.rows, out.labels, ref_rows, ref_labels)}
    if not np.array_equal(out.genes, graph.genes):
        failed.append("genes")
    if out.n_samples != graph.labels.size or out.n_edges != graph.src.size:
        failed.append("counts")
    kept = out.stop_epoch + 1
    updates = len(out.losses)
    t = plain.train(out.rows, out.labels, g, run, train_seed, device,
                    updates, keep=(kept,), clear_after=kept)
    n_val = plain.split(out.rows.shape[0], train_seed,
                        run["val_fraction"])[1].size
    failed += stop_checks(out, t.acc_val, run["epoch"], n_val)
    lp, lr_ = np.array(out.losses), np.array(t.losses)
    nums["loss"] = float(np.max(np.abs(lp - lr_) / np.abs(lr_)))
    w_ref = t.snapshots[kept].astype(np.float64)
    change = np.sign(out.w_ih.astype(np.float64) - t.w_ih0)
    n_clear = int(t.clear.sum())
    nums["flips"] = (float((change[t.clear] != t.direction[t.clear]).sum())
                     / max(n_clear, 1))
    detail = {"updates": updates, "kept": kept, "clear": n_clear,
              "loss_gaps": (np.abs(lp - lr_) / np.abs(lr_)).tolist(),
              "acc_gaps": np.abs(np.array(out.acc_val)
                                 - np.array(t.acc_val)).tolist(),
              "emb": float(np.linalg.norm(out.w_ih - w_ref)
                           / max(np.linalg.norm(w_ref - t.w_ih0), 1e-30))}
    nums["kmeans"], detail["centres"] = kmeans_gaps(out.w_ih, out.centres,
                                                    run, kmeans_seed, device)
    votes = plain.gene_votes(out.rows, out.labels, g)
    bad, naming = kmeans_checks(out.w_ih, out.centres, out.lgroups, votes)
    if bad:
        failed.append(f"lgroup:{bad}")
    if naming:
        failed.append("naming")
    s_ref = plain.scores(out.w_ih, graph.expr, graph.labels, out.lgroups,
                         run["score_mix"])
    nums["score"] = max(float(np.max(np.abs(
        out.scores[grp][out.lgroups == grp] - s_ref[grp][out.lgroups == grp]),
        initial=0.0)) for grp in (0, 1))
    bm = biomarker_violations(s_ref, out.lgroups, graph.genes,
                              out.biomarkers, run["numBiomarker"])
    if bm:
        failed.append(f"biomarkers:{bm}")
    want = {"biomarkers": text.biomarkers_text(out.biomarkers),
            "lgroups": text.lgroups_text(graph.genes, out.lgroups),
            "vectors": text.vectors_text(graph.genes, out.w_ih)}
    for name, data in want.items():
        if out.files.get(name) != data:
            failed.append(f"file:{name}")
    nums["exact"] = len(failed)
    return {"numbers": nums, "failed": failed, "detail": detail}


def combine(per_run: List[Dict]) -> Dict:
    """The widest of each number over the judged runs, and every failed
    exact check."""
    nums = {k: max(r["numbers"][k] for r in per_run) for k in NUMBERS}
    failed = [f for r in per_run for f in r["failed"]]
    return {"numbers": nums, "failed": failed}


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            failed_jobs: int = 0, judged: Optional[int] = None) -> bool:
    """Correct when every number is within its limit, no job failed, and
    something was judged."""
    if failed_jobs or judged == 0:
        return False
    return all(numbers[k] <= limits[k] for k in NUMBERS)
