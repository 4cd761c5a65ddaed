"""PyTorch/CUDA port of ``repro`` (the JAX package is its reference).

The port serves a request stream end to end on one NVIDIA H100: the
request-level tick of ``repro_torch.serve.engine`` admits arrivals into
per-cell rings (hand-written ``queue_admit`` kernel), forms rounds, steps
the vectorized fleet env (whose edge-group coupling runs the hand-written
``group_occupancy`` kernel) and scatters per-request records.  It also
serves the LM substrate (``repro_torch.serving.engine``): prefill runs
the hand-written flash-attention kernel in every attention block and the
WKV6 kernel in every RWKV6 block, then decodes token by token.  Beside
the tick, a round gateway (``repro_torch.serve.compat.replay_trace``)
replays a round trace through a policy and scores it against the exact
solver optimum (``repro_torch.fleet.solver``), as the paper judges its
orchestration policies.  The tick also runs sharded over a cells group
(``repro_torch.sharding``, the reference's ``cells`` mesh): one process
per block of cells, its cross-cell totals reduced across the group with
``torch.distributed`` (``serve_fleet --mesh-cells``).

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when no card is visible; the CPU runs only when asked for, and then
every kernel wrapper takes its plain PyTorch version.  The package imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.
"""
