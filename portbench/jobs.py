"""The job driver that every traffic mix parameterises.

A mix file (``traffic/<mix>.json``) says which entry of the port a job
calls and how:

- ``entry``: the module ``entries/<entry>.py`` that runs one job
  (``run(cfg, seed, profile_dir)``), says how many jobs of a traced
  window run under the profiler (``TRACED_JOBS``) and works out a traced
  job's kernel bounds (``work(rec, config)``);
- ``flags``: fields of the port's ``G2VecConfig``, passed to it as they
  stand (``walker_backend``, ``batch_seeds``, ``train_mode``, ...);
- ``seed_stride``: job k uses base seed ``--seed + k * seed_stride``: a
  solo job's walk, train and k-means seeds, a batch's base seed (lane l
  trains with base + l and clusters with base + l).

Jobs run back to back on one thread, a closed loop with one client. Every
job writes its files under the same name, so disk use does not grow.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from reference import plain

HERE = os.path.dirname(os.path.abspath(__file__))


def load_entry(name: str):
    """``entries/<name>.py`` as a module."""
    path = os.path.join(HERE, "entries", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_entry_" + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_config(config: Dict, mix: Dict, files: Dict[str, str],
                result_name: str, seed: int, device: str):
    """The port's ``G2VecConfig`` of one job: the configuration's run
    flags and precision, then the mix's ``flags`` as they stand."""
    from g2vec_tpu_torch.config import G2VecConfig

    run = config["run"]
    prec = config["precision"]
    cfg = G2VecConfig(
        expression_file=files["expression"],
        clinical_file=files["clinical"], network_file=files["network"],
        result_name=result_name, seed=seed, train_seed=seed,
        kmeans_seed=seed, device=device,
        compute_dtype=prec["train_compute"], param_dtype=prec["train_params"],
        **{k: run[k] for k in (
            "lenPath", "numRepetition", "sizeHiddenlayer", "learningRate",
            "epoch", "numBiomarker", "pcc_threshold", "val_fraction",
            "decision_threshold", "n_lgroups", "kmeans_iters",
            "score_mix")})
    return dataclasses.replace(cfg, **mix.get("flags", {}))


_SUFFIXES = ("biomarkers", "lgroups", "vectors")


@dataclasses.dataclass
class Unit:
    """One run, or one lane of a batch, as the judge needs it."""

    walk_seed: int
    train_seed: int
    kmeans_seed: int
    result_name: str
    result: object             # the port's PipelineResult


@dataclasses.dataclass
class JobRecord:
    index: int
    seconds: float
    stage_seconds: Dict[str, float]
    units: List[Unit]
    launches: Dict[str, int]   # packed-kernel launches during the job
    traced: Optional[Dict] = None
    shapes: List = dataclasses.field(default_factory=list)


def launch_counts() -> Dict[str, int]:
    """The port's packed-kernel launch counters (kernels on the card
    only: the CPU path launches none)."""
    from g2vec_tpu_torch.ops import packed_matmul as pm

    return {"fwd": pm.packed_matmul_fwd.launches,
            "bwd": pm.packed_matmul_bwd.launches,
            "lanes_fwd": pm.packed_matmul_lanes_fwd.launches,
            "lanes_bwd": pm.packed_matmul_lanes_bwd.launches}


def packed_work(rec: JobRecord, config: Dict, fwd_key: str,
                bwd_key: str) -> Dict[str, float]:
    """A traced job's packed-kernel bounds (seconds). The launches are the
    program's counters (``rec.launches[fwd_key]``, ``[bwd_key]``); launch
    e carries the units whose history reaches it: a unit of n updates
    runs n + 1 forwards over all its rows and n backwards over its train
    rows. A count that disagrees with the histories is an error: the
    bound would then describe other launches than the ones timed."""
    from roofline import bound_s, bwd_work, fwd_work, set_bits

    h = config["run"]["sizeHiddenlayer"]
    units = []
    for u in rec.units:
        r = u.result
        g, m_all = len(r.genes), r.paths.shape[0]
        tr, _ = plain.split(m_all, u.train_seed, config["run"]["val_fraction"])
        n_upd = len(r.train_history)
        units.append(((n_upd + 1, fwd_work(m_all, g, h, set_bits(r.paths))),
                      (n_upd, bwd_work(tr.size, g, h,
                                       set_bits(r.paths[tr])))))
    work = {}
    for col, key, name in ((0, fwd_key, "fwd_bound_s"),
                           (1, bwd_key, "bwd_bound_s")):
        counted = rec.launches[key]
        want = max(u[col][0] for u in units)
        if counted and counted != want:
            raise RuntimeError(f"{counted} {key} launches counted, "
                               f"{want} by the units' histories")
        work[name] = sum(
            bound_s(sum(u[col][1][0] for u in units if u[col][0] > e),
                    sum(u[col][1][1] for u in units if u[col][0] > e))
            for e in range(counted))
    return work


class Driver:
    """Runs a mix's jobs over one generated input set."""

    def __init__(self, config: Dict, mix: Dict, files: Dict[str, str],
                 work_dir: str, device: str):
        self.config, self.mix, self.files = config, mix, files
        self.device = device
        self.entry = load_entry(mix["entry"])
        self.out_dir = os.path.join(work_dir, "out")
        self.kept_dir = os.path.join(work_dir, "kept")
        os.makedirs(self.out_dir, exist_ok=True)
        os.makedirs(self.kept_dir, exist_ok=True)

    def load_kernels(self) -> None:
        """Build (or load from the checkout's cache) the kernels this mix
        launches."""
        if self.device != "cuda":
            return
        from g2vec_tpu_torch.ops.device_walker import build_walk_kernel
        from g2vec_tpu_torch.ops.packed_matmul import build_kernels

        build_kernels()
        if self.mix.get("flags", {}).get("walker_backend") == "device":
            build_walk_kernel()

    def job(self, index: int, base_seed: int,
            profile_dir: Optional[str] = None) -> JobRecord:
        """Job ``index`` of base seed ``base_seed``; with ``profile_dir``
        its trace is written there (``trace.json``)."""
        import time

        seed = base_seed + index * self.mix["seed_stride"]
        cfg = port_config(self.config, self.mix, self.files,
                          os.path.join(self.out_dir, "job"), seed,
                          self.device)
        before = launch_counts()
        t0 = time.perf_counter()
        units, stages = self.entry.run(cfg, seed, profile_dir)
        seconds = time.perf_counter() - t0
        after = launch_counts()
        return JobRecord(index, seconds, stages, units,
                         {k: after[k] - before[k] for k in after})

    def keep_files(self, rec: JobRecord) -> None:
        """Move a job's files aside, so that later jobs do not overwrite
        them before they are judged."""
        for u in rec.units:
            kept = os.path.join(self.kept_dir, f"{rec.index}-"
                                + os.path.basename(u.result_name))
            for suf in _SUFFIXES:
                shutil.move(f"{u.result_name}_{suf}.txt", f"{kept}_{suf}.txt")
            u.result_name = kept


def run_output(unit: Unit) -> plain.RunOutput:
    """A unit's outputs in the judge's form, with its files' bytes."""
    r = unit.result
    files = {}
    for suf in _SUFFIXES:
        with open(f"{unit.result_name}_{suf}.txt", "rb") as f:
            files[suf] = f.read()
    hist = r.train_history
    return plain.RunOutput(
        genes=np.asarray(r.genes), n_samples=int(r.n_samples),
        n_edges=int(r.n_edges), rows=np.asarray(r.paths),
        labels=np.asarray(r.labels), losses=[h["loss"] for h in hist],
        acc_val=[h["acc_val"] for h in hist], stop_epoch=int(r.stop_epoch),
        w_ih=np.asarray(r.embeddings, np.float32),
        lgroups=np.asarray(r.lgroup_idx), centres=np.asarray(r.km_centers),
        scores=np.asarray(r.biomarker_scores),
        biomarkers=list(r.biomarkers), files=files)
