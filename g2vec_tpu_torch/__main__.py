"""CLI entry: ``python -m g2vec_tpu_torch EXPR CLIN NET NAME [options]``.

Same invocation shape as the reference (``python G2Vec.py ...``) and as
``python -m g2vec_tpu``; runs on the card unless ``--device cpu``.
``--fleet-size`` and ``--supervise`` are handled before torch is
imported, so the launcher and the supervisor hold no CUDA context; their
children run the pipeline.
``--manifest``/``--seeds`` run the batch engine instead of the solo
pipeline, and ``--scenario`` a scenario on it (stats/run.py). ``python -m g2vec_tpu_torch serve ...`` runs the serve daemon,
the router over its replicas (``--replicas N``) or one of the client ops
(serve/cli.py). ``python -m g2vec_tpu_torch analyze`` runs the port's
static-analysis suite (analyze/cli.py), which imports no torch.
``--distributed`` joins a multi-process run
(parallel/distributed.py) before the pipeline; a rank whose run fails
exits 1 at once with its traceback.
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(argv) if argv is not None else sys.argv[1:]
    if argv and argv[0] == "serve":
        # The resident daemon, the router and the client ops
        # (serve/cli.py); the client side, the router and the
        # --supervise watchdog import no torch.
        from g2vec_tpu_torch.serve.cli import serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "analyze":
        # The static-analysis suite (analyze/cli.py): pure AST, so it is
        # dispatched before any config parse and imports no torch. Exit
        # codes: 0 clean, 1 findings, 2 usage.
        from g2vec_tpu_torch.analyze.cli import analyze_main

        return analyze_main(argv[1:])
    from g2vec_tpu_torch.config import config_from_args

    cfg = config_from_args(argv)
    if cfg.fleet_size:
        # The fleet launcher starts one child a rank (without the
        # launcher's flags), watches them, and when ranks die re-plans the
        # mesh over the survivors and relaunches with --resume.
        from g2vec_tpu_torch.resilience.fleet import supervise_fleet

        return supervise_fleet(cfg, argv)
    if cfg.supervise:
        # The supervisor re-runs this module (without its own flags, with
        # --resume) so that even a SIGKILLed child is restarted from its
        # last checkpoint.
        from g2vec_tpu_torch.resilience.supervisor import supervise_cli

        return supervise_cli(cfg, argv)
    if cfg.scenario:
        # The scenario engine: a seeded replicate manifest run as one lane
        # batch and reduced into <NAME>_stability.txt (stats/); validated
        # exclusive of --manifest/--seeds.
        from g2vec_tpu_torch.stats.run import run_scenario

        run_scenario(cfg)
        return 0
    if cfg.manifest or cfg.batch_seeds:
        # The batch engine: the manifest's lanes in this process
        # (batch/engine.py); --supervise and checkpointing were refused
        # with these flags at validation.
        from g2vec_tpu_torch.batch.engine import run_batch

        run_batch(cfg)
        return 0
    from g2vec_tpu_torch.pipeline import run

    if not cfg.distributed:
        run(cfg)
        return 0
    from g2vec_tpu_torch.parallel import distributed

    try:
        distributed.initialize(cfg.coordinator, cfg.process_id,
                               cfg.num_processes)
        run(cfg)
    except BaseException:
        if isinstance(sys.exc_info()[1], (KeyboardInterrupt, SystemExit)):
            raise
        # A failed rank exits at once with its traceback (the one naming
        # a dead peer, say): nothing at teardown may wait on the others.
        import os
        import traceback

        traceback.print_exc()
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(1)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
