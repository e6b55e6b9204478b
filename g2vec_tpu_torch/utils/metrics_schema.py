"""The declared schema for every MetricsWriter event kind of the port.

The port's copy of ``g2vec_tpu/utils/metrics_schema.py``; the port's
events are the JAX package's, so the table is the same (a test holds the
two equal). The metrics JSONL is an API surface: the chaos-soak
accountant sums ``job_done`` events, the router's dashboards pivot on
``failover`` latencies, and tests assert field presence. Emission,
though, is stringly typed — so this module pins, per event kind, which
fields every emission MUST carry (``required``) and which any emission
MAY carry (``optional``). The ``metrics-schema`` checker
(analyze/events.py) lints every literal ``.emit("<kind>", ...)`` site in
g2vec_tpu_torch/ against this table; adding an event kind or a field
means adding it HERE in the same commit, which is exactly the reviewable
drift signal dashboards need.

Conventions:

- Fields injected by the BoundMetrics facade (``job``, ``lane``) and
  by MetricsWriter itself (``ts``, ``seq``, ``event``) are not listed:
  they are structural, not per-site.
- Kinds emitted through a ``**fields`` splat (``config``, ``stream``,
  ``done`` extras, ``job_state`` info) declare only the literal kwargs
  their sites pass; the splat contents are deliberately open — the
  checker skips missing-field enforcement at splat sites but still
  rejects unknown literal kwargs.
- This dict is read by ``ast.literal_eval`` in the checker (never
  imported), so it must stay a pure literal.
"""

EVENT_SCHEMAS = {
    'ann_build': {
        "required": ['bundle', 'nlist', 'outcome'],
        "optional": ['error', 'ms', 'postings', 'seeded']},
    'auth_rejected': {
        "required": ['op'],
        "optional": []},
    'batch_config': {
        "required": ['batch_serial', 'lanes_cap', 'n_lanes', 'variants'],
        "optional": []},
    'batch_start': {
        "required": ['batch', 'jobs', 'n_lanes'],
        "optional": []},
    'batch_walks': {
        "required": [],
        "optional": ['lane_walks', 'n_walk_tasks']},
    'config': {
        "required": [],
        "optional": []},
    'delta_walk': {
        "required": ['group', 'outcome'],
        "optional": ['bundle', 'cache_hits', 'job_id', 'ranges_rewalked',
                     'ranges_total', 'walked_rows']},
    'device_walk': {
        "required": ['feed_mode', 'h2d_bytes_saved', 'paths_per_s'],
        "optional": ['device_recomputes', 'shards']},
    'done': {
        "required": [],
        "optional": ['acc_val', 'buckets', 'n_lanes', 'n_paths', 'outputs', 'overlap_saved_s', 'runs_per_hour', 'sampler_threads', 'stage_extras', 'stage_seconds', 'stop_epoch', 'stop_epochs', 'stream_totals', 'train_mode', 'walk_cache_hits', 'walk_stats', 'walker_backend', 'wall_seconds']},
    'drain_begin': {
        "required": ['queued', 'running', 'source'],
        "optional": []},
    'edge_partition': {
        "required": ['csr_bytes', 'gene_hi', 'gene_lo', 'mode', 'n_ranks', 'owned_edges', 'rank'],
        "optional": []},
    'epoch': {
        "required": ['acc_tr', 'acc_val', 'secs', 'step'],
        "optional": []},
    'failover': {
        "required": ['deduped', 'from_replica', 'job_id', 'latency_s', 'to_replica'],
        "optional": []},
    'failover_deferred': {
        "required": ['from_replica', 'job_id'],
        "optional": []},
    'failover_error': {
        "required": ['error', 'from_replica', 'job_id', 'to_replica'],
        "optional": []},
    'failover_reconciled': {
        "required": ['from_replica', 'job_id'],
        "optional": ['already_on']},
    'fenced': {
        "required": ['epoch', 'replica'],
        "optional": []},
    'fleet_done': {
        "required": ['attempts', 'mesh', 'ranks'],
        "optional": []},
    'fleet_launch': {
        "required": ['attempt', 'devices_per_rank', 'mesh', 'ranks', 'resume'],
        "optional": []},
    'fleet_peer_death': {
        "required": ['attempt', 'classified', 'dead_ranks', 'returncodes', 'wedged_ranks'],
        "optional": []},
    'fleet_replan': {
        "required": ['attempt', 'delay_seconds', 'new_mesh', 'old_mesh', 'surviving_devices', 'surviving_ranks'],
        "optional": []},
    'fquery': {
        "required": ['fq', 'ms'],
        "optional": ['bundles', 'error', 'replica_down', 'served_by']},
    'gave_up': {
        "required": ['attempt', 'classified', 'error'],
        "optional": []},
    'halo': {
        "required": ['halo_bytes', 'halo_edges', 'halo_genes', 'overhead_ratio'],
        "optional": []},
    'handoff': {
        "required": ['batches', 'mode', 'peak_in_flight', 'rounds', 'shards', 'states_sent'],
        "optional": []},
    'heartbeat': {
        "required": [],
        "optional": []},
    'inventory': {
        "required": ['bundle', 'bytes', 'outcome'],
        "optional": ['error', 'generation']},
    'job_accepted': {
        "required": ['n_lanes', 'priority', 'queued', 'tenant'],
        "optional": []},
    'job_cancel_requested': {
        "required": [],
        "optional": []},
    'job_deduped': {
        "required": ['tenant'],
        "optional": []},
    'job_done': {
        "required": ['batch', 'joined_jobs', 'latency_seconds', 'tenant'],
        "optional": []},
    'job_failed': {
        "required": ['classified', 'error'],
        "optional": []},
    'job_recovered_complete': {
        "required": [],
        "optional": []},
    'job_rejected': {
        "required": ['error'],
        "optional": ['detail', 'tenant']},
    'job_requeued': {
        "required": ['tenant'],
        "optional": []},
    'job_retry': {
        "required": ['attempt', 'error'],
        "optional": []},
    'job_routed': {
        "required": ['deduped', 'job_id', 'replica'],
        "optional": []},
    'job_state': {
        "required": [],
        "optional": ['state']},
    'lane_variant': {
        "required": [],
        "optional": []},
    'leader_elected': {
        "required": ['epoch', 'holder'],
        "optional": ['standby', 'takeover_s']},
    'paths': {
        "required": ['n_path_genes', 'n_paths', 'sampler_threads', 'walker_backend'],
        "optional": ['walk_cache_hits']},
    'preprocess': {
        "required": ['n_edges', 'n_genes', 'n_samples'],
        "optional": []},
    'quarantine': {
        "required": ['epoch'],
        "optional": ['parked']},
    'query': {
        "required": ['cache', 'ms', 'q'],
        "optional": ['bundle', 'error', 'mode', 'nprobe', 'recall_mode',
                     'served_by']},
    'replica_adopted': {
        "required": ['journal_depth', 'pid', 'replica'],
        "optional": []},
    'replica_drained': {
        "required": ['rc', 'replica'],
        "optional": []},
    'replica_health': {
        "required": ['from_state', 'journal_depth', 'replica', 'to_state'],
        "optional": []},
    'replica_relaunch_failed': {
        "required": ['error', 'replica'],
        "optional": []},
    'replica_relaunched': {
        "required": ['replica'],
        "optional": []},
    'replicate': {
        "required": ['acc_val', 'index', 'n_selected', 'name'],
        "optional": []},
    'republish': {
        "required": ['bundle', 'bytes', 'generation', 'mode'],
        "optional": []},
    'resume': {
        "required": ['attempt', 'checkpoint_dir'],
        "optional": []},
    'retry': {
        "required": ['attempt', 'classified', 'delay_seconds', 'error'],
        "optional": []},
    'router_start': {
        "required": ['listen', 'pid', 'replicas'],
        "optional": []},
    'router_stop': {
        "required": ['failovers', 'jobs_routed'],
        "optional": []},
    'scale_down': {
        "required": ['active', 'replica'],
        "optional": ['rc']},
    'scale_up': {
        "required": ['active', 'from_warm', 'reaction_s', 'replica'],
        "optional": []},
    'scenario': {
        "required": ['n_variants', 'scenario', 'scenario_id', 'scenario_seed', 'via'],
        "optional": ['folds', 'replicates']},
    'scheduler_error': {
        "required": ['error'],
        "optional": []},
    'serve_relaunch': {
        "required": ['attempt', 'classified', 'delay_seconds', 'error'],
        "optional": []},
    'serve_start': {
        "required": ['listen', 'pid', 'queued', 'socket', 'state_dir'],
        "optional": []},
    'serve_stop': {
        "required": ['jobs_done', 'jobs_failed', 'queued'],
        "optional": []},
    'serve_supervised_done': {
        "required": ['attempts'],
        "optional": []},
    'shed': {
        "required": ['est_wait_s', 'retry_after_s', 'tenant'],
        "optional": []},
    'stability': {
        "required": ['n_genes', 'output', 'scenario_id'],
        "optional": ['acc_mean', 'ci_hi', 'ci_lo', 'columns', 'n_replicates']},
    'stale_epoch': {
        "required": ['got_epoch', 'op', 'seen_epoch'],
        "optional": ['replica', 'side']},
    'straggler_warning': {
        "required": ['factor', 'median_seconds', 'rank', 'seconds', 'stage'],
        "optional": []},
    'stream': {
        "required": [],
        "optional": []},
    'submit_retry_later': {
        "required": ['job_id', 'journal_owner'],
        "optional": []},
    'supervised_done': {
        "required": ['attempts'],
        "optional": []},
    'tenant_quota': {
        "required": ['retry_after_s', 'tenant'],
        "optional": []},
    'train_done': {
        "required": ['acc_tr', 'acc_val', 'stop_epoch', 'stopped_early'],
        "optional": ['bucket', 'bucket_mode']},
    'update': {
        "required": ['bundle', 'generation', 'job_id'],
        "optional": ['cache_hits', 'carried_rows', 'epochs', 'mode',
                     'n_genes', 'prior_generation', 'ranges_rewalked',
                     'ranges_total', 'stop_epoch', 'walked_rows',
                     'wall_s']},
    'update_retry_later': {
        "required": ['bundle_owner', 'job_id'],
        "optional": []},
    'walk_cache': {
        "required": ['group', 'outcome'],
        "optional": ['n_rows']},
    'warm_spare': {
        "required": ['outcome', 'replica'],
        "optional": ['error', 'warmup_s']},
}
