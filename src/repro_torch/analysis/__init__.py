"""The port's analysis gate: what its programs do to the machine, and a
lint of its source (counterpart of ``repro.analysis``).

Two layers, one gate (``python -m repro_torch.analysis``):

**Layer 1 -- program contracts** (:mod:`repro_torch.analysis.contracts`,
:mod:`repro_torch.analysis.registry`).  Every entry point of the port --
the serving tick on one device, over a cells group, with live telemetry
and under the tier economy; the fleet trainer's epoch, with and without
its live lane; the oracle and ``cost_greedy`` decisions; the
orchestration kernels and flash attention; the economy's tick; the
paper's single-cell agent's update -- runs at tiny shapes under a torch
dispatch mode that records every aten op, and what it did is distilled
into a :class:`~repro_torch.analysis.contracts.ProgramContract`: its
collectives, its device-to-host copies by host lane (only the
live-emitter lanes are whitelisted), its host syncs by source line (none
in a tick or an epoch outside those lanes), its dtypes (float64 only at
the named emulation sites, complex128 never; billing int32), the state it
keeps in place, the bytes it lifts from the host, and whether two fresh
builds run the same op sequence.  Contracts are committed to
``results/analysis_contracts_torch.json``; ``--check`` fails on
undeclared drift, ``--update`` re-baselines intentionally.  Entries run
on the card by default (``--device cuda``); the CPU runs only when asked
(``--device cpu``, as the tests do), and the diffed fields come out the
same on both.

**Layer 2 -- the port's lint** (:mod:`repro_torch.analysis.lint`).  The
reference's AST rules over ``src/repro_torch/``, with the same ids and
suppressions; ``raw-env-flag`` reads strictly, since the port has no
environment flags.

The port has no counterpart of ``repro.analysis.envflags``: it reads no
``REPRO_*`` flag anywhere.
"""
