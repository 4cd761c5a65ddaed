"""Program contracts of the port: what one entry point does to the machine.

Counterpart of ``repro.analysis.contracts``.  Torch has no jaxpr, so an
entry point is not traced: it is **run** at tiny shapes under a
``TorchDispatchMode`` that records every aten op and a
``TorchFunctionMode`` that records the calls that cross to the host
(``.cpu()``, ``.numpy()``, ``.tolist()``, ``np.asarray``), and what was
recorded is distilled into a :class:`ProgramContract`:

- **collectives** -- ``repro_torch.sharding.runtime.COLLECTIVES`` counted
  around the call, by kind (the reference's ``psum`` inventory; the
  port's budget is two ``all_reduce`` a tick).
- **host_lanes** -- every device-to-host copy, named by the host lane on
  its Python stack (``repro_torch.telemetry.live.host_lane``).  A copy
  outside the lanes of ``CALLBACK_WHITELIST`` is a problem (the
  reference's non-whitelisted callback).
- **syncs** -- every op that blocks the host on a CUDA device
  (:data:`SYNC_OPS`: ``.item()`` / ``bool()`` / ``int()`` of a tensor,
  ``nonzero``, ``masked_select``, ``unique``, indexing with a boolean
  mask, ``repeat_interleave`` without ``output_size``, a tensor lifted
  from host data), by the function that ran it, with its source line in
  ``sync_sites``.  A sync outside the host lanes of a tick or an epoch is
  a problem.
- **dtypes** and **float64_sites** -- every dtype an op touches, and the
  functions (the nearest frame outside torch) that touch float64.  The
  port emulates XLA's fused multiply-adds in float64 at the sites of
  :data:`F64_SITES` only; any other site, and complex128 anywhere, is a
  problem.  Inside a kernel the dispatch mode sees nothing, so
  :func:`kernel_float64_problems` scans ``kernels/csrc/*.cu`` for
  ``double`` instead (:data:`F64_KERNEL_SITES`).
- **inplace** -- the state fields an entry declares it updates in place
  (the reference's donation) must keep their storage across the call.
- **host_copies** -- host-to-device bytes per call (tensors lifted from
  host data), with each copy of 64 KiB or more listed (the reference's
  ``large_consts``).
- **op_sequence_stable** -- two fresh builds at the same shapes run the
  same sequence of (op, dtypes, shapes) (the reference's retrace
  stability: a build that drifts would not replay as one CUDA graph).
- **n_ops** / **op_hash** -- informational, never diffed.

Every diffed field comes out the same on the CPU and on the card: the
host crossings are recorded where the program asks for them (the Python
call), not where a device makes them a copy, and the kernel modules
(``repro_torch.kernels.*``, where the CPU runs a plain version and the
card a hand-written kernel the dispatch mode cannot see into) count only
in ``n_ops`` / ``op_hash``.  Two things show on the card alone and are
recorded there as well: a copy between the host and the card that no
Python call asked for, and the ops of a CUDA-only branch.

Contracts serialize to plain dicts; the committed baseline lives at
``results/analysis_contracts_torch.json`` and :func:`diff_contracts`
reports undeclared drift against it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re
import sys
from pathlib import Path
from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.sharding.runtime import COLLECTIVES
from repro_torch.telemetry.live import CALLBACK_WHITELIST, HOST_LANES

LARGE_COPY_BYTES = 64 * 1024

# The functions that may run float64 on the device: each emulates a
# float32 fused multiply-add of the reference's compiled code (the
# product of two float32 values is exact in float64), or carries an
# integer exactly through a host lane.  Add a name here (and a reason)
# before putting float64 anywhere else.
F64_SITES = frozenset({
    "repro_torch.economy.tiers.fma32",      # billing and cost_greedy
    "repro_torch.random.uniform",           # u (hi - lo) + lo
    "repro_torch.random.erf_inv",           # its Horner steps
    "repro_torch.hltrain.trainer._emit_epoch",  # the on_epoch lane
})
# kernel sources that may hold ``double``, and the functions there: the
# SSD kernels' decay scans keep their cumulative sums in float64 (the
# forward's chunk_scan; the backward's scan_dt and its vector dac_at)
F64_KERNEL_SITES = {"ssd.cu": frozenset({
    "chunk_scan", "ssd_kernel", "scan_dt", "dac_at"})}
BANNED_DTYPES = frozenset({"complex128"})

# ops that block the host on a CUDA device whatever their arguments
SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.is_nonzero", "aten.equal",
    "aten.nonzero", "aten.masked_select", "aten._unique", "aten._unique2",
    "aten.unique_dim", "aten.unique_consecutive", "aten.lift_fresh",
})
# ops that block when an index is a boolean mask
_MASK_INDEX_OPS = frozenset({"aten.index", "aten.index_put_",
                             "aten.index_put", "aten._index_put_impl_"})
# host crossings the program asks for by name (the Python call)
_D2H_CALLS = frozenset({"cpu", "numpy", "tolist", "__array__"})
_KERNELS = "repro_torch.kernels"
_SKIP_MODULES = ("torch", "contextlib", "functools", __name__)
_CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"


@dataclasses.dataclass
class ProgramContract:
    """The recorded invariants of one entry point."""
    name: str
    device: str          # where it ran (informational)
    collectives: dict    # {kind: count}
    host_lanes: dict     # {lane or copy site: count} of device-to-host copies
    syncs: dict          # {"site:op": count}, site = lane name inside a lane
    sync_sites: list     # ["op at file:line (site)", ...] (informational)
    dtypes: list         # sorted dtype names touched by the entry's ops
    float64_sites: list  # sorted functions that ran float64 ops
    inplace: dict        # {"declared": [...], "reallocated": [...]}
    host_copies: dict    # {"bytes": n, "large": [{"site", "bytes"}, ...]}
    n_ops: int           # aten ops in one call (informational)
    op_hash: str         # digest of the op sequence (informational)
    op_sequence_stable: bool

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ProgramContract":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


class Built(NamedTuple):
    """One fresh build of an entry: ``fn(*args, **kwargs)`` is the call
    recorded; ``close()``, when given, releases what the build made."""
    fn: Callable
    args: tuple
    kwargs: dict
    close: Optional[Callable] = None


# ---------------------------------------------------------------------------
# the stack: sites and lanes


class _Where(NamedTuple):
    site: str                # module.qualname of the asking function
    line: str                # its file:line
    lane: Optional[str]      # the host lane on the stack, if any
    in_kernel: bool          # inside a kernel wrapper's call


def _where() -> _Where:
    """Walk the stack once: the nearest frame outside torch and this
    recorder (the function that asked for the op), the host lane on the
    stack, and whether a kernel module's frame is on it."""
    site = line = "?"
    lane, in_kernel = None, False
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if site == "?" and mod.split(".")[0] not in _SKIP_MODULES \
                and mod != __name__:
            path = Path(f.f_code.co_filename)
            parts = path.parts
            rel = ("/".join(parts[parts.index("src"):])
                   if "src" in parts else path.name)
            site = f"{mod}.{f.f_code.co_qualname}"
            line = f"{rel}:{f.f_lineno}"
        if lane is None:
            lane = HOST_LANES.get(f.f_code)
        in_kernel = in_kernel or mod.startswith(_KERNELS)
        f = f.f_back
    return _Where(site, line, lane, in_kernel)


# ---------------------------------------------------------------------------
# recording


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_cpu(args, kwargs) -> bool:
    """``Tensor.to(...)`` names the CPU as its target."""
    for a in list(args[1:]) + [kwargs.get("device")]:
        if isinstance(a, (str, torch.device)) and \
                torch.device(a).type == "cpu":
            return True
    return False


class _Record:
    def __init__(self):
        self.ops: list = []           # (op, dtypes, shapes)
        self.dtypes: set = set()
        self.f64: set = set()
        self.syncs: dict = {}
        self.sync_sites: list = []
        self.lanes: dict = {}
        self.h2d_bytes = 0
        self.large: list = []
        self.quiet = 0                # inside a host call asked for by name
        self.host_made: dict = {}     # id -> tensor already on the host
        self.devices: set = set()
        self.lifted: dict = {}        # id -> tensor lifted from host data
        self.moved: dict = {}         # id -> copy to the card, not a lift

    def close(self) -> None:
        """Copies to the card that no lift claimed are syncs of their
        own."""
        for _dst, src, w in self.moved.values():
            self.sync("h2d_copy", w)
            self.h2d(src, w)
        self.moved.clear()

    def sync(self, op: str, w: _Where) -> None:
        key = f"{w.lane or w.site}:{op}"
        self.syncs[key] = self.syncs.get(key, 0) + 1
        self.sync_sites.append(f"{op} at {w.line} ({w.lane or w.site})")

    def d2h(self, what: str, w: _Where) -> None:
        key = w.lane or f"{w.site} ({what})"
        self.lanes[key] = self.lanes.get(key, 0) + 1

    def h2d(self, t: torch.Tensor, w: _Where) -> None:
        n = t.numel() * t.element_size()
        self.h2d_bytes += n
        if n >= LARGE_COPY_BYTES:
            self.large.append({"site": w.site, "bytes": int(n),
                               "shape": list(t.shape), "dtype": _dtype(t)})


class _HostCalls(TorchFunctionMode):
    """Device-to-host copies where the program asks for them."""

    def __init__(self, rec: _Record):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        src = args[0] if args else None
        if isinstance(src, torch.Tensor) and (
                name in _D2H_CALLS or (name == "to"
                                       and _to_cpu(args, kwargs))):
            if id(src) not in self.rec.host_made:
                self.rec.d2h(name, _where())
            self.rec.quiet += 1
            try:
                out = func(*args, **kwargs)
            finally:
                self.rec.quiet -= 1
            if isinstance(out, torch.Tensor):
                self.rec.host_made[id(out)] = out
            return out
        return func(*args, **kwargs)


class _Ops(TorchDispatchMode):
    """Every aten op: the sequence, dtypes, float64 sites, syncs, host
    copies."""

    def __init__(self, rec: _Record):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rec = self.rec
        if rec.quiet:
            return out
        op = str(func.overloadpacket)
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        ts = ins + outs
        rec.devices |= {t.device.type for t in ts}
        rec.ops.append((str(func), tuple(_dtype(t) for t in ts),
                        tuple(tuple(t.shape) for t in ts)))
        w = _where()
        if w.in_kernel:
            return out  # plain version here, a hand-written kernel there
        dts = {_dtype(t) for t in ts}
        rec.dtypes |= dts
        if "float64" in dts:
            rec.f64.add(w.site)
        if op in SYNC_OPS:
            rec.sync(op, w)
            if op == "aten.lift_fresh":
                # torch.as_tensor(x, device=) copies, then lifts: one crossing
                rec.moved.pop(id(ins[0]), None)
                rec.h2d(outs[0], w)
                rec.lifted[id(outs[0])] = outs[0]
        elif op in _MASK_INDEX_OPS and any(
                t is not None and t.dtype == torch.bool
                for t in _tensors(args[1] if len(args) > 1 else ())):
            rec.sync(op, w)
        elif op == "aten.repeat_interleave" and \
                kwargs.get("output_size") is None:
            rec.sync(op, w)
        elif op in ("aten._to_copy", "aten.copy_") and len(ins) >= 1:
            # a crossing no Python call named (the card alone sees it)
            src = ins[1] if op == "aten.copy_" and len(ins) > 1 else ins[0]
            dst = ins[0] if op == "aten.copy_" else outs[0]
            if src.device.type == "cpu" and dst.device.type != "cpu" \
                    and id(src) not in rec.lifted:  # a lift moves on
                rec.moved[id(dst)] = (dst, src, w)  # unless a lift follows
            elif src.device.type != "cpu" and dst.device.type == "cpu":
                rec.d2h(op, w)
        return out


def _get(root, path: str):
    """``"2.rec.served"`` → ``root[2].rec.served``."""
    head, *rest = path.split(".")
    x = root[int(head)]
    for p in rest:
        x = getattr(x, p)
    return x


def _record(built: Built, inplace: Mapping[str, str]):
    rec = _Record()
    before = {p: _get(built.args, p).data_ptr() for p in inplace}
    coll0 = dict(COLLECTIVES)
    try:
        with _HostCalls(rec), _Ops(rec):
            out = built.fn(*built.args, **built.kwargs)
        rec.close()
        outs = out if isinstance(out, tuple) else (out,)
        moved = sorted(p for p, q in inplace.items()
                       if _get(outs, q).data_ptr() != before[p])
    finally:
        if built.close is not None:
            built.close()
    coll = {k: COLLECTIVES[k] - coll0[k] for k in COLLECTIVES
            if COLLECTIVES[k] != coll0[k]}
    return rec, coll, moved


def op_fingerprint(ops: list) -> str:
    return hashlib.sha256(repr(ops).encode()).hexdigest()[:16]


def run_contract(name: str, build: Callable[[], Built], *,
                 inplace: Mapping[str, str] = None) -> ProgramContract:
    """Run one entry point and extract its contract.

    ``build()`` returns a fresh :class:`Built` each call.  A first build
    runs and its record is dropped (it fills the port's per-device caches
    and builds the kernels); of two more, the first gives the contract
    and the second must run the same op sequence.  ``inplace`` maps each
    declared in-place field, as a path into the arguments
    (``"2.q_ids"``), to the same field in the outputs (``"0.q_ids"``)."""
    inplace = dict(inplace or {})
    _record(build(), {})
    rec, coll, moved = _record(build(), inplace)
    rec2, _, _ = _record(build(), {})
    return ProgramContract(
        name=name,
        device=",".join(sorted(rec.devices)) or "?",
        collectives=coll,
        host_lanes=dict(sorted(rec.lanes.items())),
        syncs=dict(sorted(rec.syncs.items())),
        sync_sites=rec.sync_sites,
        dtypes=sorted(rec.dtypes),
        float64_sites=sorted(rec.f64),
        inplace={"declared": sorted(inplace), "reallocated": moved},
        host_copies={"bytes": rec.h2d_bytes, "large": rec.large},
        n_ops=len(rec.ops),
        op_hash=op_fingerprint(rec.ops),
        op_sequence_stable=rec.ops == rec2.ops,
    )


# ---------------------------------------------------------------------------
# policy checks and baseline diff


def contract_problems(c: ProgramContract, *, hot: bool = False,
                      host_loop: bool = False) -> list:
    """Absolute policy violations, whatever the committed baseline says;
    each message names the contract and the rule.  ``hot`` marks a tick
    or a training epoch (no sync outside the host lanes); ``host_loop``
    an entry whose loop runs on the host by design (the single-cell
    agent: its copies and syncs are baselined, not banned)."""
    problems = []
    for dt in c.dtypes:
        if dt in BANNED_DTYPES:
            problems.append(f"[{c.name}] dtype: banned dtype {dt} on the "
                            f"device")
    for site in c.float64_sites:
        if site not in F64_SITES:
            problems.append(
                f"[{c.name}] float64: float64 op in {site}, which is not "
                f"one of F64_SITES {sorted(F64_SITES)}")
    if not host_loop:
        for where, n in c.host_lanes.items():
            if where not in CALLBACK_WHITELIST:
                problems.append(
                    f"[{c.name}] host-copy: {n} device-to-host cop"
                    f"{'y' if n == 1 else 'ies'} at {where}, outside the "
                    f"host lanes {sorted(CALLBACK_WHITELIST)}")
    if hot and not host_loop:
        for key, n in c.syncs.items():
            where, op = key.rsplit(":", 1)
            if where not in CALLBACK_WHITELIST:
                lines = sorted({s.split(" ")[2] for s in c.sync_sites
                                if s.startswith(f"{op} at ")
                                and s.endswith(f"({where})")})
                problems.append(
                    f"[{c.name}] host-sync: {n} x {op} in {where} inside "
                    f"the tick, at {', '.join(lines)}")
    if c.inplace["reallocated"]:
        problems.append(
            f"[{c.name}] inplace: declared in-place fields "
            f"{c.inplace['reallocated']} were reallocated by the call")
    if not c.op_sequence_stable:
        problems.append(
            f"[{c.name}] op-sequence: two fresh builds at the same shapes "
            f"ran different op sequences")
    return problems


_DIFFED_FIELDS = ("collectives", "host_lanes", "syncs", "dtypes",
                  "float64_sites", "inplace", "host_copies")


def diff_contracts(baseline: Mapping[str, Mapping[str, Any]],
                   current: Mapping[str, ProgramContract]) -> list:
    """Undeclared drift of current contracts vs the committed baseline,
    over :data:`_DIFFED_FIELDS` only: never ``n_ops``, ``op_hash``,
    ``sync_sites`` or ``device``, which move with refactors, source
    lines and the device's route to a kernel."""
    msgs = []
    for name in sorted(set(baseline) - set(current)):
        msgs.append(f"[{name}] contract present in baseline but no longer "
                    f"run -- removed entry points need --update")
    for name in sorted(set(current) - set(baseline)):
        msgs.append(f"[{name}] new entry point not in baseline -- run "
                    f"--update to declare it")
    for name in sorted(set(current) & set(baseline)):
        cur, base = current[name].to_dict(), baseline[name]
        for field in _DIFFED_FIELDS:
            if cur[field] != base.get(field):
                msgs.append(f"[{name}] {field} drifted: baseline "
                            f"{base.get(field)!r} -> current {cur[field]!r}")
    return msgs


_FN_RE = re.compile(r"\b([A-Za-z_]\w*)\s*\(")


def _strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group(0).count("\n"),
                 src, flags=re.S)
    return re.sub(r"//[^\n]*", "", src)


def kernel_float64_sites(csrc: Path = _CSRC) -> list:
    """``(file, function, line)`` of every ``double`` in the kernel
    sources, the function being the last one whose definition starts at
    column 0 above it."""
    out = []
    for path in sorted(Path(csrc).glob("*.cu")):
        fn = None
        for i, line in enumerate(
                _strip_comments(path.read_text()).splitlines(), 1):
            if line[:1].isalpha() or line[:1] == "_":
                names = [n for n in _FN_RE.findall(line)
                         if not n.startswith("__")]
                if names:
                    fn = names[0]
            if re.search(r"\bdouble\b", line):
                out.append((path.name, fn, i))
    return out


def kernel_float64_problems(csrc: Path = _CSRC,
                            allowed: Mapping = None) -> list:
    """A ``double`` in a kernel source outside :data:`F64_KERNEL_SITES`."""
    allowed = F64_KERNEL_SITES if allowed is None else allowed
    return [f"[kernels] float64: double in {f}:{i} ({fn}), outside "
            f"F64_KERNEL_SITES {dict((k, sorted(v)) for k, v in allowed.items())}"
            for f, fn, i in kernel_float64_sites(csrc)
            if fn not in allowed.get(f, ())]
