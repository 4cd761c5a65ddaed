"""The port's analysis gate (``repro_torch.analysis``) on the CPU.

Each class of fault the gate exists for is injected into a toy entry and
run through the real CLI (``main(argv, entries=...)``) against a baseline
written by ``--update`` from the clean toy, so the exit code and the
message are the ones a user sees: an extra ``all_reduce``, a reallocated
in-place field, a float64 op outside ``F64_SITES``, a device-to-host copy
outside the host lanes, a host sync in a tick, an unstable op sequence.
The clean toy passes beside each.  Then the whole registry runs against
the committed ``results/analysis_contracts_torch.json``, the port's lint
gives ``repro.analysis.lint``'s findings on the reference tests' snippets
(``raw-env-flag`` reads more strictly), and the registry's entries and
configurations are the reference's.
"""
import ast
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import lint as ref_lint
from repro.analysis import registry as ref_registry
from repro.telemetry import live as ref_live
from repro_torch.analysis import contracts, lint, registry
from repro_torch.analysis.__main__ import load_baseline, main
from repro_torch.analysis.contracts import Built, F64_SITES
from repro_torch.analysis.registry import ENTRIES, Entry, run_check
from repro_torch.economy.tiers import fma32
from repro_torch.sharding.runtime import (all_reduce, cells_group,
                                          destroy_cells_group)
from repro_torch.telemetry.live import CALLBACK_WHITELIST, host_lane

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "results" / "analysis_contracts_torch.json"
PORT = ROOT / "src" / "repro_torch"


def _gate(capsys, argv, entries=None) -> tuple:
    rc = main(["--device", "cpu", *argv], entries=entries)
    out = capsys.readouterr()
    return rc, out.out + out.err


def _baseline_then_check(capsys, tmp_path, clean: Entry, faulty: Entry):
    """``--update`` from ``clean``, then ``--check`` of ``faulty`` under
    the same name: (exit code, output)."""
    base = str(tmp_path / "b.json")
    rc, out = _gate(capsys, ["--update", "--baseline", base], (clean,))
    assert rc == 0, out
    rc, out = _gate(capsys, ["--check", "--baseline", base], (clean,))
    assert rc == 0, out
    return _gate(capsys, ["--check", "--baseline", base], (faulty,))


def _contract(entry: Entry) -> contracts.ProgramContract:
    return registry.trace_all(None, (entry,), device="cpu")[entry.name]


# ---------------------------------------------------------------------------
# fault 1: an extra all_reduce (the reference's TestPsumDrift)


def _toy_sharded(n_reduce: int) -> Entry:
    def build(device):
        g = cells_group(device)
        x = torch.ones(4, device=device)

        def tick(x):
            for _ in range(n_reduce):
                all_reduce(x, g)
            return x * 2.0

        return Built(tick, (x,), {}, lambda: destroy_cells_group(g))
    return Entry("toy_sharded", build, hot=True)


class TestCollectiveDrift:
    def test_extra_all_reduce_fails_with_named_contract(self, capsys,
                                                        tmp_path):
        rc, out = _baseline_then_check(capsys, tmp_path, _toy_sharded(1),
                                       _toy_sharded(2))
        assert rc == 1
        assert "[toy_sharded] collectives drifted" in out, out
        assert "{'all_reduce': 1}" in out and "{'all_reduce': 2}" in out

    def test_all_reduce_counted_per_call(self):
        assert _contract(_toy_sharded(2)).collectives == {"all_reduce": 2}
        assert _contract(_toy_sharded(0)).collectives == {}

    def test_sharded_tick_within_its_budget(self):
        # the committed sharded epoch: two all_reduce a live tick
        c = contracts.ProgramContract.from_dict(
            load_baseline(BASELINE)["serve_epoch_sharded"])
        assert c.collectives["all_reduce"] > 0
        assert registry._check_all_reduce_budget(c) == []
        over = contracts.ProgramContract.from_dict(
            dict(c.to_dict(), collectives={
                "all_reduce": c.collectives["all_reduce"] + 1}))
        msgs = registry._check_all_reduce_budget(over)
        assert any("[serve_epoch_sharded] collectives" in m
                   and "budget" in m for m in msgs), msgs


# ---------------------------------------------------------------------------
# fault 2: a reallocated in-place field (the reference's TestDonationDrop)


def _toy_inplace(in_place: bool) -> Entry:
    def build(device):
        def run(state, x):
            if in_place:
                state.add_(x)
                return state, x.sum()
            return state + x, x.sum()
        return Built(run, (torch.zeros(8, device=device),
                           torch.ones(8, device=device)), {})
    return Entry("toy_inplace", build, inplace=(("0", "0"),), hot=True)


class TestInplaceDrop:
    def test_reallocated_field_fails_with_named_contract(self, capsys,
                                                         tmp_path):
        rc, out = _baseline_then_check(capsys, tmp_path, _toy_inplace(True),
                                       _toy_inplace(False))
        assert rc == 1
        assert "[toy_inplace] inplace: declared in-place fields ['0']" \
            in out, out

    def test_kept_storage_passes(self):
        c = _contract(_toy_inplace(True))
        assert c.inplace == {"declared": ["0"], "reallocated": []}
        assert contracts.contract_problems(c, hot=True) == []

    def test_baseline_diff_reports_lost_declaration(self):
        declared = _contract(_toy_inplace(True))
        undeclared = _contract(_toy_inplace(True)._replace(inplace=()))
        msgs = contracts.diff_contracts(
            {"toy_inplace": declared.to_dict()}, {"toy_inplace": undeclared})
        assert any("[toy_inplace] inplace drifted" in m for m in msgs)


# ---------------------------------------------------------------------------
# fault 3: float64 outside F64_SITES (the reference's TestF64Injection)


def _toy_cast(x):
    return x.double().sum()


def _toy_f64(rogue: bool) -> Entry:
    def build(device):
        x = torch.linspace(0, 1, 4, device=device)
        if rogue:
            return Built(_toy_cast, (x,), {})
        return Built(fma32, (x, 0.5, x), {})  # a named emulation site
    return Entry("toy_f64", build)


class TestF64Injection:
    def test_injected_f64_fails(self, capsys, tmp_path):
        rc, out = _baseline_then_check(capsys, tmp_path, _toy_f64(False),
                                       _toy_f64(True))
        assert rc == 1
        assert "[toy_f64] float64: float64 op in " in out, out
        assert "_toy_cast" in out

    def test_named_site_passes(self):
        c = _contract(_toy_f64(False))
        assert c.float64_sites == ["repro_torch.economy.tiers.fma32"]
        assert contracts.contract_problems(c) == []

    def test_f32_passes(self):
        c = _contract(Entry("toy_f32", lambda d: Built(
            torch.sum, (torch.ones(4, device=d),), {})))
        assert "float64" not in c.dtypes
        assert contracts.contract_problems(c) == []

    def test_complex128_always_banned(self):
        c = _contract(Entry("toy_c128", lambda d: Built(
            lambda x: x.to(torch.complex128).abs(),
            (torch.ones(4, device=d),), {})))
        msgs = contracts.contract_problems(c)
        assert any("[toy_c128] dtype: banned dtype complex128" in m
                   for m in msgs), msgs

    def test_kernel_sources_scanned(self, tmp_path):
        # the committed kernels hold double only in the SSD decay scans
        assert contracts.kernel_float64_problems() == []
        sites = {(f, fn) for f, fn, _ in contracts.kernel_float64_sites()}
        assert sites == {("ssd.cu", fn) for fn in (
            "chunk_scan", "ssd_kernel", "scan_dt", "dac_at")}
        (tmp_path / "toy.cu").write_text(textwrap.dedent("""\
            // a double in a comment is not code
            __global__ void toy_kernel(float* x) {
              double acc = 0.0;
              x[0] = static_cast<float>(acc);
            }
            """))
        msgs = contracts.kernel_float64_problems(tmp_path)
        assert msgs == [
            "[kernels] float64: double in toy.cu:3 (toy_kernel), outside "
            "F64_KERNEL_SITES {'ssd.cu': ['chunk_scan', 'dac_at', "
            "'scan_dt', 'ssd_kernel']}"]
        assert contracts.kernel_float64_problems(
            tmp_path, {"toy.cu": {"toy_kernel"}}) == []

    def test_f64_sites_are_the_named_functions(self):
        assert F64_SITES == {
            "repro_torch.economy.tiers.fma32", "repro_torch.random.uniform",
            "repro_torch.random.erf_inv",
            "repro_torch.hltrain.trainer._emit_epoch"}
        base = load_baseline(BASELINE)
        used = {s for c in base.values() for s in c["float64_sites"]}
        assert used <= F64_SITES


# ---------------------------------------------------------------------------
# fault 4: a device-to-host copy outside the lanes (TestRogueCallback)


@host_lane("on_window")
def _toy_window_lane(x):
    return x.sum().cpu().numpy()


@host_lane("on_rogue")
def _toy_rogue_lane(x):
    return x.sum().cpu().numpy()


def _toy_copy(how: str) -> Entry:
    def build(device):
        fn = {"lane": _toy_window_lane, "rogue_lane": _toy_rogue_lane,
              "bare": lambda x: x.sum().tolist(),
              "none": lambda x: x.sum()}[how]
        return Built(fn, (torch.ones(4, device=device),), {})
    return Entry("toy_copy", build, hot=True)


class TestRogueCopy:
    def test_copy_outside_lanes_fails_with_named_contract(self, capsys,
                                                          tmp_path):
        rc, out = _baseline_then_check(capsys, tmp_path, _toy_copy("none"),
                                       _toy_copy("bare"))
        assert rc == 1
        assert "[toy_copy] host-copy: 1 device-to-host copy at " in out, out
        assert "(tolist), outside the host lanes ['on_epoch', 'on_window']" \
            in out
        assert "[toy_copy] host_lanes drifted" in out

    def test_lane_not_in_whitelist_fails(self):
        c = _contract(_toy_copy("rogue_lane"))
        assert c.host_lanes == {"on_rogue": 1}
        msgs = contracts.contract_problems(c, hot=True)
        assert any("[toy_copy] host-copy" in m and "on_rogue" in m
                   for m in msgs), msgs

    def test_whitelisted_lane_passes(self):
        # .cpu() then .numpy() of the host copy: one crossing
        c = _contract(_toy_copy("lane"))
        assert c.host_lanes == {"on_window": 1}
        assert contracts.contract_problems(c, hot=True) == []

    def test_live_entries_carry_exactly_their_lanes(self):
        base = load_baseline(BASELINE)
        assert set(base["serve_epoch_live"]["host_lanes"]) == {"on_window"}
        assert set(base["hltrain_run_live"]["host_lanes"]) == {"on_epoch"}
        for name in ("serve_epoch", "serve_epoch_sharded",
                     "serve_epoch_economy", "hltrain_run"):
            assert base[name]["host_lanes"] == {}, name

    def test_whitelist_is_the_references(self):
        assert CALLBACK_WHITELIST == ref_live.CALLBACK_WHITELIST


# ---------------------------------------------------------------------------
# fault 5: a host sync in the tick


def _toy_tick(index_fill: bool) -> Entry:
    """The tick's record scatter as it was (a Python True assigned by
    index: lifted to a host tensor, copied over) and as it is."""
    def build(device):
        served = torch.zeros(9, dtype=torch.bool, device=device)
        flat = torch.tensor([1, 8, 8, 3], dtype=torch.int32, device=device)

        def tick(served, flat):
            if index_fill:
                served.index_fill_(0, flat.long(), True)
            else:
                served[flat] = True
            return served, flat.sum()

        return Built(tick, (served, flat), {})
    return Entry("toy_tick", build, inplace=(("0", "0"),), hot=True)


class TestSyncInjection:
    def test_scalar_index_assignment_fails(self, capsys, tmp_path):
        rc, out = _baseline_then_check(capsys, tmp_path, _toy_tick(True),
                                       _toy_tick(False))
        assert rc == 1
        assert "[toy_tick] host-sync: 1 x aten.lift_fresh in " in out, out
        assert "test_torch_analysis.py:" in out  # the source line
        assert "[toy_tick] syncs drifted" in out

    def test_index_fill_passes(self):
        c = _contract(_toy_tick(True))
        assert c.syncs == {} and c.host_copies["bytes"] == 0
        assert contracts.contract_problems(c, hot=True) == []

    @pytest.mark.parametrize("op,fn", [
        ("aten._local_scalar_dense", lambda x: x.sum().item()),
        ("aten._local_scalar_dense", lambda x: bool(x.sum() > 0)),
        ("aten.nonzero", lambda x: torch.nonzero(x)),
        ("aten.index", lambda x: x[x > 0]),
        ("aten.repeat_interleave",
         lambda x: torch.repeat_interleave(torch.tensor([1, 2]))),
    ])
    def test_each_sync_kind_is_caught(self, op, fn):
        c = _contract(Entry("toy_sync", lambda d: Built(
            fn, (torch.ones(4, device=d),), {}), hot=True))
        assert any(k.endswith(f":{op}") for k in c.syncs), c.syncs
        assert any("[toy_sync] host-sync" in m for m in
                   contracts.contract_problems(c, hot=True))

    def test_sync_outside_a_tick_is_baselined_not_banned(self):
        c = _contract(Entry("toy_sync", lambda d: Built(
            lambda x: x.sum().item(), (torch.ones(4, device=d),), {})))
        assert c.syncs and contracts.contract_problems(c) == []

    def test_tick_has_no_scalar_index_assignment(self):
        # serve/engine.py: no `x[...] = <constant>` anywhere in the tick
        tree = ast.parse((PORT / "serve" / "engine.py").read_text())
        tick = next(n for n in ast.walk(tree)
                    if isinstance(n, ast.FunctionDef)
                    and n.name == "live_tick")
        bad = [n.lineno for n in ast.walk(tick)
               if isinstance(n, ast.Assign)
               and isinstance(n.targets[0], ast.Subscript)
               and isinstance(n.value, ast.Constant)]
        assert bad == []


# ---------------------------------------------------------------------------
# fault 6: an unstable op sequence (the reference's TestRetraceStability)


def _toy_unstable() -> Entry:
    builds = {"n": 0}

    def build(device):
        builds["n"] += 1
        n = builds["n"]

        def run(x):
            for _ in range(n):  # a build that drifts from call to call
                x = x + 1.0
            return x

        return Built(run, (torch.ones(4, device=device),), {})
    return Entry("toy_unstable", build, hot=True)


class TestOpSequenceStability:
    def test_unstable_sequence_fails_with_named_contract(self, capsys,
                                                         tmp_path):
        stable = Entry("toy_unstable", lambda d: Built(
            lambda x: x + 1.0, (torch.ones(4, device=d),), {}), hot=True)
        rc, out = _baseline_then_check(capsys, tmp_path, stable,
                                       _toy_unstable())
        assert rc == 1
        assert "[toy_unstable] op-sequence: two fresh builds" in out, out

    def test_update_refuses_a_policy_problem(self, capsys, tmp_path):
        base = tmp_path / "b.json"
        rc, out = _gate(capsys, ["--update", "--baseline", str(base)],
                        (_toy_unstable(),))
        assert rc == 1 and not base.exists()
        assert "[toy_unstable] op-sequence" in out


# ---------------------------------------------------------------------------
# the committed baseline, the registry and the CLI


@pytest.fixture(scope="module")
def current():
    return registry.trace_all(device="cpu")


class TestBaseline:
    def test_baseline_committed_and_complete(self):
        base = load_baseline(BASELINE)
        assert base is not None, "results/analysis_contracts_torch.json"
        assert set(base) == {e.name for e in ENTRIES}

    def test_full_registry_passes_against_the_baseline(self, current):
        assert run_check(current, load_baseline(BASELINE)) == []

    @pytest.mark.parametrize("name", [e.name for e in ENTRIES])
    def test_entry_stable_and_in_place(self, current, name):
        c = current[name]
        assert c.op_sequence_stable, name
        assert c.inplace["reallocated"] == [], name
        assert "complex128" not in c.dtypes, name

    def test_ticks_and_epochs_make_no_sync(self, current):
        for e in ENTRIES:
            if e.hot:
                assert current[e.name].syncs == {}, e.name
                assert current[e.name].host_copies["bytes"] == 0, e.name

    def test_single_device_tick_is_collective_free(self, current):
        assert current["serve_epoch"].collectives == {}
        assert current["serve_epoch_sharded"].collectives == {
            "all_reduce": registry.ALL_REDUCE_PER_TICK * 4}

    def test_billing_integer(self, current):
        assert registry._check_billing_integer(
            current["economy_advance"]) == []

    def test_run_check_flags_new_and_missing_entries(self, current):
        c = current["oracle_act"]
        msgs = run_check({"oracle_act": c}, {})
        assert any("[oracle_act] new entry point" in m for m in msgs)
        msgs = run_check({}, {"gone": c.to_dict()})
        assert any("[gone] contract present in baseline" in m
                   for m in msgs)

    def test_baseline_version_checked(self, tmp_path):
        p = tmp_path / "b.json"
        p.write_text('{"version": 0, "contracts": {}}')
        with pytest.raises(ValueError, match="baseline version"):
            load_baseline(p)


class TestCLI:
    def test_check_and_lint_pass_on_the_committed_baseline(self, capsys):
        rc, out = _gate(capsys, ["--check", "--lint", "--only",
                                 "oracle_act,orch_queue_admit,"
                                 "economy_advance"])
        assert rc == 0, out
        assert "lint: 0 finding(s)" in out
        assert "analysis gate OK: 3 contract(s)" in out

    def test_unknown_only_raises(self, capsys):
        with pytest.raises(KeyError, match="nope"):
            _gate(capsys, ["--check", "--only", "oracle_act,nope"])

    def test_update_with_only_exits_2(self, capsys, tmp_path):
        rc, _ = _gate(capsys, ["--update", "--only", "oracle_act",
                               "--baseline", str(tmp_path / "b.json")])
        assert rc == 2

    def test_missing_baseline_exits_1(self, capsys, tmp_path):
        rc, out = _gate(capsys, ["--check", "--only", "oracle_act",
                                 "--baseline", str(tmp_path / "none.json")])
        assert rc == 1 and "no committed baseline" in out

    def test_lint_only(self, capsys, tmp_path):
        assert _gate(capsys, ["--lint-only"])[0] == 0
        (tmp_path / "bad.py").write_text(
            'import os\nFLAG = os.environ.get("REPRO_FOO")\n')
        rc, out = _gate(capsys, ["--lint-only", "--lint-path",
                                 str(tmp_path)])
        assert rc == 1 and "[raw-env-flag]" in out

    def test_card_by_default(self, capsys):
        if torch.cuda.is_available():
            pytest.skip("a card is visible: the default runs there")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--check", "--only", "oracle_act"])


# ---------------------------------------------------------------------------
# the registry is the reference's


class TestRegistryParity:
    def test_entries_are_the_references_and_one(self):
        names = {e.name for e in ENTRIES}
        assert names - {e.name for e in ref_registry.ENTRIES} == {
            "single_cell_update"}
        assert {e.name for e in ref_registry.ENTRIES} <= names

    @pytest.mark.parametrize("port,ref", [
        ("_SERVE_CFG", "_SERVE_CFG"),
        ("_SERVE_SHARDED_CFG", "_SERVE_SHARDED_CFG"),
        ("_SERVE_ECON_CFG", "_SERVE_ECON_CFG"),
    ])
    def test_serve_configs(self, port, ref):
        got, want = getattr(registry, port), getattr(ref_registry, ref)
        for f in ("n_max", "obs_spec", "tick_ms", "queue_cap",
                  "shared_cloud", "shared_edge", "telemetry", "window_ms"):
            assert getattr(got, f) == getattr(want, f), f
        assert (got.economy is None) == (want.economy is None)
        if got.economy is not None:
            assert got.economy.name == want.economy.name

    def test_live_config_closes_windows(self):
        # the reference's, with windows that close inside the epoch run
        got, want = registry._SERVE_LIVE_CFG, ref_registry._SERVE_LIVE_CFG
        assert (got.n_max, got.obs_spec, got.queue_cap, got.telemetry) == (
            want.n_max, want.obs_spec, want.queue_cap, want.telemetry)
        assert got.window_ms < 200.0  # the recorded epoch spans 200 ms

    def test_trainer_params(self):
        got, want = registry._HL_PARAMS, ref_registry._HL_PARAMS
        for f in ("epochs", "n_direct", "t_direct", "n_world", "n_suggest",
                  "t_suggest", "n_plan", "k_best", "batch", "direct_cap",
                  "world_cap", "plan_cap", "hidden"):
            assert getattr(got, f) == getattr(want, f), f


# ---------------------------------------------------------------------------
# the port's lint against the reference's, on the reference tests'
# snippets (tests/test_analysis_lint.py)


_SNIPPETS = {
    "host_time_in_jit": """
        import time, jax

        @jax.jit
        def f(x):
            return x + time.time()
    """,
    "np_random_in_traced_arg": """
        import jax
        import numpy as np

        def body(x):
            return x + np.random.random()

        step = jax.jit(body)
    """,
    "np_in_traced": """
        import jax
        import numpy as np

        @jax.jit
        def f(x):
            return np.round(x)
    """,
    "np_in_call_edge_closure": """
        import jax
        import numpy as np

        def helper(x):
            return np.asarray(x)

        @jax.jit
        def f(x):
            return helper(x)
    """,
    "np_in_nested_def": """
        import jax
        import numpy as np

        @jax.jit
        def f(x):
            def inner(y):
                return np.abs(y)
            return inner(x)
    """,
    "raw_env_get": 'import os\nFLAG = os.environ.get("REPRO_FOO")\n',
    "raw_env_getenv": 'import os\nFLAG = os.getenv("REPRO_FOO", "1")\n',
    "raw_env_subscript": 'import os\nFLAG = os.environ["REPRO_FOO"]\n',
    "non_repro_env_reads": 'import os\nHOME = os.environ.get("HOME")\n',
    "env_flag_scope": """
        from repro.analysis import envflags

        def f():
            return envflags.bool_flag(envflags.ORCH_KERNELS, True)
    """,
    "module_scope_bool_flag": """
        from repro.analysis import envflags
        USE = envflags.bool_flag(envflags.ORCH_KERNELS, True)
    """,
    "unfrozen_config_dataclass": """
        import dataclasses

        @dataclasses.dataclass
        class ToyConfig:
            x: int = 0
    """,
    "frozen_config": """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class ToyParams:
            x: int = 0
    """,
    "non_config_name": """
        import dataclasses

        @dataclasses.dataclass
        class Stopwatch:
            t: float = 0.0
    """,
    "suppress_line": """
        import jax
        import numpy as np

        @jax.jit
        def f(x):
            return np.round(x)  # repro-lint: allow=np-in-traced
    """,
    "suppress_wrong_rule": """
        import jax
        import numpy as np

        @jax.jit
        def f(x):
            return np.round(x)  # repro-lint: allow=host-time-in-jit
    """,
    "suppress_def_line": """
        import jax
        import numpy as np

        @jax.jit
        def f(x):  # repro-lint: allow=np-in-traced
            y = np.round(x)
            return np.abs(y)
    """,
    "suppress_def_line_nested": """
        import jax
        import numpy as np

        @jax.jit
        def f(x):  # repro-lint: allow=np-in-traced
            def inner(y):
                return np.abs(y)
            return inner(x)
    """,
    "same_named_defs": """
        import jax
        import numpy as np

        def jitted_factory():
            @jax.jit
            def act(params, obs):
                return obs * 2
            return act

        def host_factory():
            def act(params, obs):
                return int(np.argmax(obs))
            return act
    """,
    "tracer_arg_enclosing_scope": """
        import jax
        import numpy as np

        def factory():
            def act(obs):
                return np.argmax(obs)
            return jax.jit(act)
    """,
}
# where the port reads more strictly: it has no environment flags, so a
# bool_flag call is a REPRO_* read wherever it stands
_STRICTER = {"env_flag_scope": ["raw-env-flag"],
             "module_scope_bool_flag": ["raw-env-flag"]}


class TestLintParity:
    @pytest.mark.parametrize("name", sorted(_SNIPPETS))
    def test_same_findings_as_the_reference(self, name):
        code = textwrap.dedent(_SNIPPETS[name])
        got = [(f.line, f.rule) for f in lint.lint_source(code, "toy.py")]
        want = [(f.line, f.rule)
                for f in ref_lint.lint_source(code, "toy.py")]
        if name in _STRICTER:
            assert [r for _, r in got] == _STRICTER[name]
            assert [r for _, r in want] != _STRICTER[name]
        else:
            assert got == want

    def test_rule_ids_are_the_references(self):
        assert lint.RULES == ref_lint.RULES

    def test_port_is_clean(self):
        findings = lint.lint_paths([str(PORT)])
        assert findings == [], "\n".join(f.format() for f in findings)

    def test_reference_env_reads_are_findings_here(self):
        # the reference's own flag reads: sanctioned there, not here
        findings = lint.lint_paths([str(ROOT / "src" / "repro" / "fleet"
                                        / "latency.py")])
        assert {f.rule for f in findings} == {"raw-env-flag"}

    def test_isolation_test_walks_the_new_files(self):
        files = set(sorted(PORT.rglob("*.py")))
        for rel in ("analysis/__init__.py", "analysis/__main__.py",
                    "analysis/contracts.py", "analysis/registry.py",
                    "analysis/lint.py"):
            assert PORT / rel in files, rel
        # the glob tests/test_torch_isolation.py builds its cases from
        src = (ROOT / "tests" / "test_torch_isolation.py").read_text()
        assert 'sorted(PORT.rglob("*.py"))' in src
