"""The ``serve`` subcommand of the port: daemon, watchdog and client modes.

The port's copy of ``g2vec_tpu/serve/cli.py``, run as
``python -m g2vec_tpu_torch serve ...``. Daemon::

    serve --socket /tmp/g2vec.sock --state-dir /tmp/g2vec-serve \\
        [--queue-depth 16] [--max-join 4] [--cache-dir DIR] \\
        [--metrics-jsonl F] [--device cpu] [--supervise] \\
        [--listen HOST:PORT] [--auth-token-file F] [--ann-nlist N]

Router (fleet front door; ``--state-dir`` becomes the fleet root)::

    serve --replicas 3 --listen 0.0.0.0:7433 --state-dir /srv/g2vec \\
        [--device cpu] [--auth-token-file F] [--probe-interval 0.5] \\
        [--probe-deadline 2] [--cache-dir DIR] [--queue-depth 16] \\
        [--max-join 4] [--lease-ttl-s 5] [--standby] [--join-spread K] \\
        [--remote-replicas]

Client (``--socket`` takes a UNIX path or a TCP host:port: a daemon or
the router)::

    serve --socket /tmp/g2vec.sock --submit job.json [--tenant me] \\
        [--priority interactive|batch] [--deadline-s SECS] \\
        [--auth-token-file F]
    serve --socket host:7433 --status | --ping | --shutdown
    serve --socket host:7433 --cancel JOB_ID | --drain
    serve --socket host:7433 --drain-replica r1
    serve --socket host:7433 --query list
    serve --socket host:7433 --query neighbors --query-job i1234 \\
        --query-gene TP53 --query-k 10 [--query-variant v] \\
        [--exact | --nprobe N]
    serve --socket host:7433 --query topk_biomarkers --query-job i1234
    serve --socket host:7433 --fquery gene_rank --query-gene TP53
    serve --socket host:7433 --fquery bundle_overlap \\
        --query-gene TP53 --query-job i1234 [--query-k 50]
    serve --socket host:7433 --result JOB_ID \\
        [--fields event,variants] [--max-bytes 65536]

``--submit`` streams the job's JSONL events to stdout and exits 0 on
``job_done``, 4 on ``rejected``, 5 on ``job_failed`` (or any other
terminal state), 6 when the daemon connection is lost mid-job (the job
is journaled — poll ``<state-dir>/results/<job_id>.json`` or resubmit
--status later); a client op that cannot reach the daemon exits 3.
``--drain`` asks the daemon to stop admitting, checkpoint in-flight
streaming jobs, and exit 0 with everything unfinished journaled for the
next start.

``--device`` takes the place of the JAX package's ``--platform``: the
daemon runs on the card unless ``--device cpu``, and exits non-zero at
start when no card is visible. In router mode the flag is forwarded to
every replica, and a replica that cannot boot fails the router's start
(exit 1). A submit file that holds a whole ``update`` envelope
(``"op": "update"``, ``job_id``, ``idem_key``, ``job``) goes to the
``update`` op (``client.update_job``).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional



def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="g2vec-tpu-torch serve",
        description="Resident g2vec service: a long-lived daemon owning "
                    "the device and every warm cache, accepting streaming "
                    "job manifests over a local UNIX socket with admission "
                    "control and shape-bucket-aware scheduling.")
    p.add_argument("--socket", default=None, metavar="ADDR",
                   help="UNIX socket path the daemon listens on. Client "
                        "ops also accept a TCP host:port here (a daemon's "
                        "--listen address or the router). curl "
                        "--unix-socket / plain curl work for /status.")
    p.add_argument("--listen", type=str, default=None, metavar="HOST:PORT",
                   help="TCP front door: ALSO listen on this address "
                        "(port 0 = ephemeral; the bound address lands in "
                        "<state-dir>/tcp_addr). Same JSONL protocol + "
                        "GET /status as the UNIX socket.")
    p.add_argument("--auth-token-file", type=str, default=None,
                   metavar="FILE",
                   help="Shared-secret tenancy: mutating ops (submit/"
                        "cancel/drain/shutdown) must carry this file's "
                        "token as 'auth_token'; status/ping stay open. "
                        "In client mode, the token to send.")
    p.add_argument("--read-deadline-s", type=float, default=30.0,
                   metavar="S",
                   help="Per-connection socket deadline (default 30): a "
                        "stalled or byte-trickling client can hold an "
                        "acceptor thread at most this long.")
    p.add_argument("--max-request-bytes", type=int, default=0,
                   metavar="N",
                   help="Reject request lines over this size (default 0 "
                        "= the protocol's 8 MiB line bound).")
    # router mode
    p.add_argument("--replicas", type=int, default=None, metavar="N",
                   help="Router mode: front N daemon replicas under "
                        "--state-dir (consistent-hash placement, health "
                        "probes, exactly-once failover). Needs --listen.")
    p.add_argument("--probe-interval", type=float, default=0.5,
                   metavar="S",
                   help="Router health-probe cadence for healthy replicas "
                        "(default 0.5); unhealthy ones back off "
                        "exponentially.")
    p.add_argument("--probe-deadline", type=float, default=2.0,
                   metavar="S",
                   help="One probe's socket deadline (default 2); a "
                        "replica that cannot answer /status within it "
                        "fails the probe.")
    p.add_argument("--sticky-deadline", type=float, default=120.0,
                   metavar="S",
                   help="How long a keyed submit waits for an already-"
                        "journaled key's home replica to recover before "
                        "it is refused with retry_later (default 120); "
                        "never ring-placed elsewhere, which would run "
                        "the job twice.")
    p.add_argument("--min-replicas", type=int, default=0, metavar="N",
                   help="Router mode: elastic floor — the scaling "
                        "controller may drain the active set down to N "
                        "(default 0 = track --replicas; the fleet stays "
                        "static unless min < max).")
    p.add_argument("--max-replicas", type=int, default=0, metavar="N",
                   help="Router mode: elastic ceiling — sustained queue "
                        "pressure grows the active set up to N "
                        "(default 0 = track --replicas).")
    p.add_argument("--warm-spares", type=int, default=0, metavar="N",
                   help="Router mode: keep N spare daemons launched "
                        "(CUDA context up, zero jobs) but out of the "
                        "ring, so a scale-up is a ring add instead of a "
                        "cold boot; the pool refills in the background "
                        "after each promotion (default 0).")
    p.add_argument("--warmup-job", default=None, metavar="FILE",
                   help="Router mode: canary job payload (JSON) run "
                        "through every spare right after it parks in "
                        "the warm pool — out of the ring, result "
                        "discarded — so the first CUDA use, the kernels' "
                        "load and the parse are paid while the spare "
                        "idles instead of on its first post-promotion "
                        "batch (default: no pre-warming).")
    p.add_argument("--scale-interval", type=float, default=1.0,
                   metavar="S",
                   help="Router scaling-control cadence: one /status "
                        "sweep of the active set and one policy tick "
                        "per interval (default 1.0).")
    p.add_argument("--standby", action="store_true",
                   help="Router mode: start as a STANDBY — watch the "
                        "fleet's leadership lease and take over (epoch "
                        "+1, adopting the running replicas) only when "
                        "the active router's lease expires or is "
                        "released. Implies leased leadership.")
    p.add_argument("--lease-ttl-s", type=float, default=0.0, metavar="S",
                   help="Router mode: enable leased leadership with "
                        "this ttl (default 0 = no lease machinery; "
                        "--standby without it uses 5s). The leader "
                        "renews at ttl/3; on loss it keeps serving "
                        "reads while daemons fence its mutations as "
                        "stale_epoch.")
    p.add_argument("--join-spread", type=int, default=1, metavar="K",
                   help="Router mode: bounded per-join-key placement "
                        "spread — a hot key may land on any of K salted "
                        "ring candidates, least-loaded first (default 1 "
                        "= classic single-home placement). Keyed "
                        "(idem_key) submits stay sticky regardless.")
    p.add_argument("--remote-replicas", action="store_true",
                   help="Router mode: the fleet's daemons are launched "
                        "and supervised elsewhere — adopt them via "
                        "their published tcp_addr files, never spawn, "
                        "SIGKILL-verify, or relaunch locally. An "
                        "unreachable remote replica is fenced (marker + "
                        "epoch) before its journal migrates.")
    p.add_argument("--state-dir", default=None, metavar="DIR",
                   help="Daemon state root: jobs/ (journal of accepted, "
                        "unfinished jobs — re-queued on restart), "
                        "results/ (durable per-job terminal records), "
                        "spool/ (in-flight lane outputs before routing).")
    p.add_argument("--queue-depth", type=int, default=16, metavar="N",
                   help="Max queued jobs before admission rejects with a "
                        "structured queue_full error (default 16).")
    p.add_argument("--tenant-quotas", type=str, default=None,
                   metavar="SPEC",
                   help="Per-tenant admission SLOs: semicolon-separated "
                        "'name:rate:burst[:weight]' entries — a token "
                        "bucket (rate jobs/s, burst capacity) plus a "
                        "weighted-fair queue share; '*' sets the "
                        "default for unlisted tenants. Over-rate "
                        "submits reject with tenant_quota + "
                        "retry_after_s.")
    p.add_argument("--shed", action="store_true",
                   help="Deadline-aware load shedding: reject a "
                        "deadline-carrying submit whose estimated wait "
                        "(queue depth x observed service time) already "
                        "exceeds its deadline_s — a structured 'shed' "
                        "response with retry_after_s, instead of "
                        "accepting work that will die of "
                        "deadline_exceeded.")
    p.add_argument("--max-join", type=int, default=4, metavar="K",
                   help="Max shape-compatible jobs merged into one engine "
                        "batch per scheduling cycle (default 4).")
    p.add_argument("--job-retries", type=int, default=1, metavar="N",
                   help="In-process re-queues for a job whose batch failed "
                        "retryably (default 1).")
    p.add_argument("--cache-dir", type=str, default=None, metavar="DIR",
                   help="Walk cache root (sha256-verified stage-3 path "
                        "sets): what makes a supervised relaunch walk "
                        "nothing it walked before.")
    p.add_argument("--metrics-jsonl", type=str, default=None,
                   help="Daemon-lifetime JSONL metrics stream; every "
                        "job-scoped event carries job_id (and lane).")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu. Without a card, the "
                        "daemon exits non-zero at start instead of "
                        "serving on the CPU.")
    p.add_argument("--fault-plan", type=str, default=None, metavar="SPEC",
                   help="Fault-injection spec for chaos drills "
                        "(resilience/faults.py grammar).")
    # query plane (daemon-side knobs)
    p.add_argument("--inventory-budget-bytes", type=int,
                   default=256 << 20, metavar="N",
                   help="Byte budget for the memory-mapped bundle LRU "
                        "(default 256 MiB); least-recently-queried "
                        "bundles unmap when the mapped set exceeds it.")
    p.add_argument("--query-cache-entries", type=int, default=128,
                   metavar="N",
                   help="Entries in the keyed query-result LRU "
                        "(default 128).")
    p.add_argument("--inventory-dir", type=str, default=None,
                   metavar="DIR",
                   help="Extra inventory root beyond <state-dir>/"
                        "inventory — point the daemon at a directory of "
                        "solo --emit-inventory bundles to make them "
                        "queryable.")
    p.add_argument("--ann-nlist", type=int, default=0, metavar="N",
                   help="IVF coarse-quantizer list count for published "
                        "bundle indexes: 0 (default) auto-sizes to "
                        "~sqrt(G) once a bundle clears the row floor, "
                        "N>0 forces N lists on every bundle, N<0 "
                        "disables index builds entirely. Approx "
                        "queries on index-less bundles silently serve "
                        "exact.")
    p.add_argument("--max-result-bytes", type=int, default=0, metavar="N",
                   help="Server-side cap on one 'result' response "
                        "(default 0 = the 8 MiB line bound); over-cap "
                        "records answer with a structured "
                        "oversized_result error naming the available "
                        "fields.")
    # watchdog
    p.add_argument("--supervise", action="store_true",
                   help="Run the daemon under the relaunch watchdog: a "
                        "crash/SIGKILL restarts it, the journal re-queues "
                        "in-flight jobs, --cache-dir restores warm state.")
    p.add_argument("--supervise-retries", type=int, default=3)
    p.add_argument("--supervise-backoff", type=float, default=1.0)
    # client ops
    p.add_argument("--submit", type=str, default=None, metavar="JOB.json",
                   help="Client mode: submit this job file and stream its "
                        "events to stdout ('-' reads stdin).")
    p.add_argument("--tenant", type=str, default="default",
                   help="Tenant name for --submit (fair-share unit).")
    p.add_argument("--priority", type=str, default=None,
                   choices=("interactive", "batch"),
                   help="Priority class for --submit: interactive pops "
                        "before batch; aging keeps batch from starving "
                        "(default batch).")
    p.add_argument("--deadline-s", type=float, default=None, metavar="S",
                   help="Wall-clock budget for --submit, measured from "
                        "submission (survives daemon restarts); an "
                        "overdue job terminates deadline_exceeded at the "
                        "next shard/chunk boundary.")
    p.add_argument("--status", action="store_true",
                   help="Client mode: print the daemon status JSON.")
    p.add_argument("--ping", action="store_true",
                   help="Client mode: liveness probe (exit 0 iff alive).")
    p.add_argument("--shutdown", action="store_true",
                   help="Client mode: stop the daemon after its current "
                        "batch; queued jobs stay journaled.")
    p.add_argument("--cancel", type=str, default=None, metavar="JOB_ID",
                   help="Client mode: cancel a queued (immediate) or "
                        "running (next boundary) job.")
    p.add_argument("--drain", action="store_true",
                   help="Client mode: graceful drain — stop admitting, "
                        "checkpoint in-flight streaming jobs, journal "
                        "everything unfinished, exit 0.")
    p.add_argument("--drain-replica", type=str, default=None,
                   metavar="NAME",
                   help="Client mode (router): drain one replica "
                        "synchronously and relaunch it; prints the exit "
                        "code the drained daemon returned.")
    # client query plane
    p.add_argument("--query", type=str, default=None,
                   choices=("neighbors", "topk_biomarkers", "meta",
                            "list"),
                   help="Client mode: one read-plane query against a "
                        "daemon or the router (token-gated — query "
                        "responses carry tenant embeddings/scores).")
    p.add_argument("--query-job", type=str, default=None,
                   metavar="JOB_ID",
                   help="Bundle address for --query: the job whose "
                        "published embedding bundle to read (or a solo "
                        "bundle's directory name under --inventory-dir).")
    p.add_argument("--query-variant", type=str, default=None,
                   metavar="NAME",
                   help="Variant lane of --query-job (optional when the "
                        "job has exactly one).")
    p.add_argument("--query-gene", type=str, default=None, metavar="SYM",
                   help="Gene symbol for --query neighbors.")
    p.add_argument("--query-k", type=int, default=10, metavar="K",
                   help="Result count for --query neighbors / "
                        "topk_biomarkers (default 10).")
    p.add_argument("--exact", action="store_true",
                   help="Force the exact scan for --query neighbors "
                        "(mode=exact), bypassing any ANN index — the "
                        "ground-truth baseline for the approx plane.")
    p.add_argument("--nprobe", type=int, default=0, metavar="N",
                   help="IVF lists probed per approx neighbors query "
                        "(default 0 = the server's default; values >= "
                        "nlist are exact-equivalent).")
    p.add_argument("--fquery", type=str, default=None,
                   choices=("gene_rank", "bundle_overlap"),
                   help="Client mode: one federated cross-bundle query "
                        "— gene_rank ('which bundles rank --query-gene "
                        "in their top --query-k biomarkers') or "
                        "bundle_overlap ('bundles nearest the "
                        "reference bundle by neighbor-set overlap'; "
                        "the reference is --query-job/--query-variant). "
                        "Routed, it scatter-gathers across the fleet; "
                        "dead replicas' bundles answer from shared "
                        "disk with replica_down attribution.")
    p.add_argument("--result", type=str, default=None, metavar="JOB_ID",
                   help="Client mode: fetch a job's durable terminal "
                        "record via the 'result' op.")
    p.add_argument("--fields", type=str, default=None, metavar="K1,K2",
                   help="Comma-separated top-level record keys --result "
                        "should return (default: all).")
    p.add_argument("--max-bytes", type=int, default=None, metavar="N",
                   help="Client-side cap on the --result response; an "
                        "over-cap record answers oversized_result with "
                        "the available field names.")
    return p


def _read_token(path: Optional[str]) -> Optional[str]:
    if not path:
        return None
    with open(path) as f:
        tok = f.read().strip()
    if not tok:
        raise SystemExit(f"auth token file {path!r} is empty")
    return tok


def serve_main(argv: Optional[List[str]] = None) -> int:
    args = build_serve_parser().parse_args(argv)
    from g2vec_tpu_torch.serve import client

    if args.status or args.ping or args.shutdown or args.submit \
            or args.cancel or args.drain or args.drain_replica \
            or args.query or args.fquery or args.result:
        if not args.socket:
            build_serve_parser().error(
                "client ops need --socket (a UNIX path or host:port)")
        token = _read_token(args.auth_token_file)
        try:
            if args.status:
                print(json.dumps(client.status(args.socket), indent=1))
                return 0
            if args.ping:
                print(json.dumps(client.ping(args.socket)))
                return 0
            if args.shutdown:
                ev = client.shutdown(args.socket, auth_token=token)
                print(json.dumps(ev))
                return 0 if ev.get("event") not in ("rejected",
                                                    "error") else 4
            if args.cancel:
                ev = client.cancel(args.socket, args.cancel,
                                   auth_token=token)
                print(json.dumps(ev))
                return 0 if ev.get("event") not in ("rejected",
                                                    "error") else 4
            if args.drain:
                ev = client.drain(args.socket, auth_token=token)
                print(json.dumps(ev))
                return 0 if ev.get("event") not in ("rejected",
                                                    "error") else 4
            if args.query:
                ev = client.query(args.socket, args.query,
                                  job_id=args.query_job,
                                  variant=args.query_variant,
                                  gene=args.query_gene,
                                  k=args.query_k,
                                  mode=("exact" if args.exact else None),
                                  nprobe=(args.nprobe or None),
                                  auth_token=token)
                print(json.dumps(ev, indent=1))
                return 0 if ev.get("event") == "query_result" else 4
            if args.fquery:
                ev = client.fquery(args.socket, args.fquery,
                                   args.query_gene,
                                   k=args.query_k,
                                   mode=("exact" if args.exact
                                         else None),
                                   nprobe=(args.nprobe or None),
                                   job_id=args.query_job,
                                   variant=args.query_variant,
                                   auth_token=token)
                print(json.dumps(ev, indent=1))
                return 0 if ev.get("event") == "fquery_result" else 4
            if args.result:
                ev = client.result(
                    args.socket, args.result,
                    fields=(args.fields.split(",") if args.fields
                            else None),
                    max_bytes=args.max_bytes, auth_token=token)
                print(json.dumps(ev, indent=1))
                return 0 if ev.get("event") not in ("rejected",
                                                    "error") else 4
            if args.drain_replica:
                for ev in client.request(
                        args.socket,
                        {"op": "drain_replica",
                         "replica": args.drain_replica,
                         "auth_token": token}, timeout=600.0):
                    print(json.dumps(ev))
                    return 0 if ev.get("event") == "drained" else 4
                return 4
            src = sys.stdin if args.submit == "-" else open(args.submit)
            with src:
                job = json.load(src)
            try:
                # A submit file may hold the whole ``update`` envelope
                # (op/job_id/idem_key/job/...): it goes to the update op,
                # not into a plain submit's job object (where the schema
                # would reject ``op`` as an unknown key).
                if isinstance(job, dict) and job.get("op") == "update":
                    events = client.update_job(
                        args.socket, job.get("job_id", ""),
                        job.get("job", {}),
                        idem_key=job.get("idem_key", ""),
                        variant=job.get("variant"),
                        epochs=int(job.get("epochs", 0) or 0),
                        tenant=args.tenant,
                        priority=args.priority,
                        deadline_s=args.deadline_s,
                        auth_token=token)
                else:
                    events = client.submit_job(args.socket, job,
                                               tenant=args.tenant,
                                               priority=args.priority,
                                               deadline_s=args.deadline_s,
                                               auth_token=token)
            except client.ServeConnectionLost as e:
                print(json.dumps({"event": "connection_lost",
                                  "job_id": e.job_id, "error": str(e)}))
                return 6
            for ev in events:
                print(json.dumps(ev))
            last = events[-1].get("event") if events else None
            return {"job_done": 0, "rejected": 4}.get(last, 5)
        except OSError as e:
            print(json.dumps({"event": "error",
                              "error": f"cannot reach daemon at "
                                       f"{args.socket}: {e}"}),
                  file=sys.stderr)
            return 3

    if not args.state_dir:
        build_serve_parser().error(
            "daemon/router mode needs --state-dir (or pass a client op: "
            "--submit/--status/--ping/--shutdown)")
    if args.replicas is not None:
        # Router mode imports no torch: the replicas own the card; this
        # process only probes, places and fails over.
        if args.replicas < 1:
            build_serve_parser().error("--replicas must be >= 1")
        if not args.listen:
            build_serve_parser().error("router mode needs --listen")
        from g2vec_tpu_torch.serve.router import Router, RouterOptions

        fwd: List[str] = ["--queue-depth", str(args.queue_depth),
                          "--max-join", str(args.max_join),
                          "--job-retries", str(args.job_retries),
                          "--read-deadline-s", str(args.read_deadline_s),
                          "--inventory-budget-bytes",
                          str(args.inventory_budget_bytes),
                          "--query-cache-entries",
                          str(args.query_cache_entries),
                          "--ann-nlist", str(args.ann_nlist),
                          "--device", args.device]
        if args.max_request_bytes:
            fwd += ["--max-request-bytes", str(args.max_request_bytes)]
        if args.max_result_bytes:
            fwd += ["--max-result-bytes", str(args.max_result_bytes)]
        if args.inventory_dir:
            fwd += ["--inventory-dir", args.inventory_dir]
        if args.tenant_quotas:
            fwd += ["--tenant-quotas", args.tenant_quotas]
        if args.shed:
            fwd += ["--shed"]
        if args.cache_dir:
            fwd += ["--cache-dir", args.cache_dir]
        if args.fault_plan:
            fwd += ["--fault-plan", args.fault_plan]
        opts = RouterOptions(
            fleet_dir=args.state_dir, replicas=args.replicas,
            listen=args.listen, probe_interval=args.probe_interval,
            probe_deadline=args.probe_deadline,
            auth_token=_read_token(args.auth_token_file),
            read_deadline_s=args.read_deadline_s,
            max_request_bytes=args.max_request_bytes,
            metrics_jsonl=args.metrics_jsonl,
            sticky_deadline_s=args.sticky_deadline,
            inventory_budget_bytes=args.inventory_budget_bytes,
            max_result_bytes=args.max_result_bytes,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            warm_spares=args.warm_spares,
            warmup_job=args.warmup_job,
            scale_interval=args.scale_interval,
            standby=args.standby,
            lease_ttl_s=args.lease_ttl_s,
            join_spread=args.join_spread,
            remote_replicas=args.remote_replicas,
            serve_argv=tuple(fwd))
        return Router(opts).serve_forever()
    if not args.socket:
        build_serve_parser().error("daemon mode needs --socket")
    if args.supervise:
        from g2vec_tpu_torch.resilience.supervisor import supervise_serve

        return supervise_serve(
            list(argv) if argv is not None else sys.argv[2:],
            retries=args.supervise_retries,
            backoff=args.supervise_backoff,
            metrics_jsonl=args.metrics_jsonl,
            state_dir=args.state_dir)
    from g2vec_tpu_torch.serve.daemon import ServeDaemon, ServeOptions

    opts = ServeOptions(
        socket_path=args.socket, state_dir=args.state_dir,
        device=args.device,
        queue_depth=args.queue_depth, max_join=args.max_join,
        job_retries=args.job_retries, cache_dir=args.cache_dir,
        metrics_jsonl=args.metrics_jsonl, fault_plan=args.fault_plan,
        listen=args.listen, auth_token=_read_token(args.auth_token_file),
        read_deadline_s=args.read_deadline_s,
        max_request_bytes=args.max_request_bytes,
        inventory_budget_bytes=args.inventory_budget_bytes,
        query_cache_entries=args.query_cache_entries,
        inventory_dir=args.inventory_dir,
        ann_nlist=args.ann_nlist,
        max_result_bytes=args.max_result_bytes,
        tenant_quotas=args.tenant_quotas, shed=args.shed)
    try:
        daemon = ServeDaemon(opts)
    except RuntimeError as e:
        # No card (device.resolve_device): say so and exit non-zero.
        print(f"[serve] cannot start: {e}", file=sys.stderr)
        return 1
    return daemon.serve_forever()
