"""PyTorch/CUDA port of the fleet serving stack (``repro``'s counterpart).

The port serves a request stream end to end on one NVIDIA H100: the
request-level tick of ``repro_torch.serve.engine`` admits arrivals into
per-cell rings (hand-written ``queue_admit`` kernel), forms rounds, steps
the vectorized fleet env (whose edge-group coupling runs the hand-written
``group_occupancy`` kernel) and scatters per-request records.

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when no card is visible; the CPU runs only when asked for, and then
every kernel wrapper takes its plain PyTorch version.  The package imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.
"""
