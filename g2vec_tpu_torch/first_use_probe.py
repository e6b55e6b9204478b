"""The card's first use, measured in fresh processes: what the stage
overlap's background warm-up can hide.

Run on a machine with a card, from the repository root:

    python -m g2vec_tpu_torch.first_use_probe [--genes 5850] [--hidden 128]

Each part of the first use is timed on the host clock in the order a solo
run meets them: the CUDA context, the kernel library's load, each
kernel's first launch, then one bf16 trainer step's and stages 5-6's
torch ops on throwaway tensors at the given widths, and those two again,
warm. Two fresh interpreters run the
parts: the first alone (the durations), the second beside a Python thread
that counts while it holds the interpreter lock. The count over a part,
against the count over a sleep of the same length, is the share of the
part during which the counter got the lock: near 1, the part releases it
(native work that runs beside any Python); about one half, the part is
Python that hands the lock over at every switch interval; near 0, native
code that holds the lock throughout. A warm-up of a part below 1 on a
second thread cannot run beside the main thread's Python at full speed,
only beside native work that releases the lock (the C++ walks and
reader, waits on the device). Prints one JSON object per process and a summary
line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time


def _train_step(genes: int, hidden: int, dev, rows: int = 256) -> None:
    """One bf16 step of the trainer on throwaway tensors at the given
    widths: the kernels (through their uncounted helpers) and every torch
    op of a step (the logits, the loss and its gradient, the Adam update,
    the accuracy)."""
    import torch

    from g2vec_tpu_torch.models.cbow import (CBOW, accuracy_from_logits,
                                             masked_bce_loss, output_logits)
    from g2vec_tpu_torch.ops import packed_matmul as pm
    from g2vec_tpu_torch.train.trainer import _Adam

    model = CBOW(torch.zeros((genes, hidden), device=dev),
                 torch.zeros((hidden, 1), device=dev))
    x = torch.zeros((rows, pm.padded_row_bytes(genes)), dtype=torch.uint8,
                    device=dev)
    y = torch.zeros((rows, 1), device=dev)
    w = torch.ones_like(y)
    w16 = pm._pad_cols(model.w_ih.detach().to(torch.bfloat16), 8)
    h = pm._fwd_on_card(x, w16)[:, :hidden].requires_grad_()
    logits = output_logits(h, model.w_ho)
    masked_bce_loss(logits, y, w).backward()
    g16 = pm._pad_cols(h.grad.to(torch.bfloat16), 8)
    model.w_ih.grad = pm._bwd_on_card(
        x, g16, genes, pm._bwd_slices(rows, genes, hidden,
                                      pm._sm_count(dev.index or 0))
    )[:, :hidden]
    _Adam([model.w_ih, model.w_ho], 1e-3).step([model.w_ih, model.w_ho])
    accuracy_from_logits(logits.detach(), y, w).item()


def _lgroups(genes: int, hidden: int, dev, n_good: int = 77,
             n_poor: int = 58) -> None:
    """Stages 5 and 6 once on throwaway tensors (one Lloyd iteration)."""
    import numpy as np
    import torch

    from g2vec_tpu_torch.analysis import biomarker_scores, find_lgroups

    gen = torch.Generator().manual_seed(0)
    emb = torch.randn((genes, hidden), generator=gen).to(dev)
    lgroup, _ = find_lgroups(emb, np.full(genes, 2, np.int32),
                             generator=gen, iters=1)
    expr = torch.randn((n_good + n_poor, genes), generator=gen).to(dev)
    biomarker_scores(emb, expr[:n_good], expr[n_good:], lgroup).cpu()


def _parts(genes: int, hidden: int):
    import torch

    from g2vec_tpu_torch.ops import packed_matmul as pm

    dev = torch.device("cuda")

    def kernels():
        x = torch.zeros((256, pm.padded_row_bytes(genes)), dtype=torch.uint8,
                        device=dev)
        w16 = torch.zeros((genes, hidden), dtype=torch.bfloat16, device=dev)
        g16 = torch.zeros((256, hidden), dtype=torch.bfloat16, device=dev)
        pm._fwd_on_card(x, w16)
        pm._bwd_on_card(x, g16, genes, pm._bwd_slices(256, genes, hidden,
                                                      pm._sm_count(0)))

    def trainer():
        _train_step(genes, hidden, dev)

    def lgroups():
        _lgroups(genes, hidden, dev)

    return [("context", lambda: torch.empty(1, device=dev)),
            ("kernel_library", pm._lib), ("kernel_first_launch", kernels),
            ("trainer_ops", trainer), ("lgroups_ops", lgroups),
            ("trainer_ops_warm", trainer), ("lgroups_ops_warm", lgroups)]


class _Counter:
    """A thread that counts while it holds the interpreter lock."""

    def __init__(self):
        self.n = 0
        self._stop = False
        self._thread = threading.Thread(target=self._spin, daemon=True)
        self._thread.start()

    def _spin(self):
        while not self._stop:
            self.n += 1

    def over(self, fn):
        """(seconds, counts) over ``fn()``."""
        import torch

        n0, t0 = self.n, time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, self.n - n0

    def stop(self):
        self._stop = True
        self._thread.join()


def _child(genes: int, hidden: int, count: bool) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    counter = _Counter() if count else None
    for name, fn in _parts(genes, hidden):
        if counter is None:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[name] = time.perf_counter() - t0
            continue
        secs, n = counter.over(fn)
        # The counter's rate with the lock free, over a sleep as long.
        n0 = counter.n
        time.sleep(secs)
        free = max(counter.n - n0, 1)
        out[name] = {"seconds": secs, "lock_free_share": min(n / free, 1.0)}
    if counter is not None:
        counter.stop()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--genes", type=int, default=5850)
    parser.add_argument("--hidden", type=int, default=128)
    parser.add_argument("--child", choices=("time", "count"), default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print(json.dumps(_child(args.genes, args.hidden,
                                args.child == "count")))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("first_use_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    from g2vec_tpu_torch.ops.packed_matmul import build_kernels

    build_kernels()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    results = {}
    for mode in ("time", "count"):
        proc = subprocess.run(
            [sys.executable, "-m", "g2vec_tpu_torch.first_use_probe",
             "--genes", str(args.genes), "--hidden", str(args.hidden),
             "--child", mode], capture_output=True, text=True, env=env,
            timeout=600, check=True)
        results[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({mode: results[mode]}))
    print(json.dumps({name: {
        "seconds": round(secs, 4),
        "lock_free_share": round(results["count"][name]["lock_free_share"],
                                 3)} for name, secs in results["time"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
