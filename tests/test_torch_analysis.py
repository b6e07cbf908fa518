"""splint over the port (``repro_torch.analysis``): each rule fires on a
PyTorch fixture tree with known violations (exact rule ids and file:line
spans), the deliberate exceptions are held both ways, and the real tree
runs clean end to end through the CLI's main, whose exit codes are held. The
cases of ``tests/test_analysis.py``, retargeted."""
import ast
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import FAMILIES
from repro_torch.analysis.astutil import ProjectIndex, reachable_functions
from repro_torch.analysis.faults import FaultSpec, check_faults
from repro_torch.analysis.findings import Baseline, Finding
from repro_torch.analysis.kernel_contract import KernelSpec, check_kernel_contract
from repro_torch.analysis.plan_lifecycle import (
    DEFAULT_CONTRACTS,
    ContractSpec,
    Leg,
    check_plan_lifecycle,
)
from repro_torch.analysis.purity import (
    DEFAULT_ENTRIES,
    HOST_BOUNDARIES,
    PuritySpec,
    check_purity,
)

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"


def _write(root: Path, rel: str, body: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(body), encoding="utf-8")


# --------------------------------------------------------------------- #
# PL: plan lifecycle
# --------------------------------------------------------------------- #
def _toy_contract() -> tuple[ContractSpec, ...]:
    return (
        ContractSpec(
            name="ToyPlan",
            dataclass_path="pkg/plan.py",
            dataclass_name="ToyPlan",
            legs=(
                Leg("repad", "pkg/plan.py", "repad"),
                Leg("signature", "pkg/sig.py", "signature"),
                Leg("staging", "pkg/stage.py", "to_device"),
            ),
        ),
    )


def _toy_tree(tmp_path: Path, *, sig_handles_beta: bool = True) -> Path:
    beta_sig = "p.beta.shape," if sig_handles_beta else ""
    _write(tmp_path, "pkg/plan.py", """
        from dataclasses import dataclass

        @dataclass
        class ToyPlan:
            alpha: object
            beta: object
            gamma: object

        def repad(p, hwm):
            for name in ("alpha", "beta"):
                setattr(p, name, pad(getattr(p, name)))
            return p
        """)
    _write(tmp_path, "pkg/sig.py", f"""
        def signature(p):
            return (p.alpha.shape, {beta_sig})
        """)
    # the port's staging shape: the leg names nothing itself; a helper of
    # its own file yields the keys of a module-level tuple
    _write(tmp_path, "pkg/stage.py", """
        import torch

        KEYS = ("alpha", "beta")

        def _fields(p):
            for key in KEYS:
                yield key, getattr(p, key)

        def to_device(p, device):
            return {k: torch.as_tensor(a, device=device)
                    for k, a in _fields(p)}
        """)
    return tmp_path


GAMMA = {("ToyPlan", "gamma", leg): "host-side only"
         for leg in ("repad", "signature", "staging")}


def test_pl001_unhandled_field_names_field_and_missing_site(tmp_path):
    root = _toy_tree(tmp_path)
    findings = check_plan_lifecycle(root, _toy_contract(), exemptions={})
    keys = {(f.rule, f.message.split(" — ")[0]) for f in findings}
    # gamma skips every leg; alpha/beta are covered by a loop, an attribute
    # and (staging) a helper's module-level key tuple
    assert keys == {
        ("PL001", "ToyPlan.gamma is not handled in the repad leg"),
        ("PL001", "ToyPlan.gamma is not handled in the signature leg"),
        ("PL001", "ToyPlan.gamma is not handled in the staging leg"),
    }
    assert all(f.path == "pkg/plan.py" and f.line == 8 for f in findings)
    assert "pkg/plan.py" in findings[0].message


def test_pl001_exemption_with_reason_suppresses(tmp_path):
    root = _toy_tree(tmp_path)
    assert check_plan_lifecycle(root, _toy_contract(), dict(GAMMA)) == []


def test_pl003_stale_exemption_fires_when_field_becomes_handled(tmp_path):
    root = _toy_tree(tmp_path)
    exemptions = {**GAMMA, ("ToyPlan", "beta", "signature"): "obsolete"}
    findings = check_plan_lifecycle(root, _toy_contract(), exemptions)
    assert [f.rule for f in findings] == ["PL003"]
    assert "beta" in findings[0].message


def test_deleting_signature_leg_fails_with_pointer(tmp_path):
    root = _toy_tree(tmp_path, sig_handles_beta=False)
    findings = check_plan_lifecycle(root, _toy_contract(), dict(GAMMA))
    assert len(findings) == 1
    f = findings[0]
    assert f.rule == "PL001"
    assert "ToyPlan.beta" in f.message and "signature" in f.message
    assert "pkg/sig.py" in f.message
    assert f.path == "pkg/plan.py" and f.line == 7


def test_pl002_exemption_for_removed_field(tmp_path):
    root = _toy_tree(tmp_path)
    exemptions = {**GAMMA, ("ToyPlan", "deleted_field", "repad"): "removed"}
    findings = check_plan_lifecycle(root, _toy_contract(), exemptions)
    assert [f.rule for f in findings] == ["PL002"]
    assert "deleted_field" in findings[0].message


def test_pl004_missing_leg_function(tmp_path):
    root = _toy_tree(tmp_path)
    contracts = (ContractSpec(
        name="ToyPlan", dataclass_path="pkg/plan.py", dataclass_name="ToyPlan",
        legs=(Leg("repad", "pkg/plan.py", "renamed_away"),)),)
    findings = check_plan_lifecycle(root, contracts, exemptions={})
    assert [f.rule for f in findings] == ["PL004"]
    assert "renamed_away" in findings[0].message


def test_pl005_empty_reason(tmp_path):
    root = _toy_tree(tmp_path)
    exemptions = {**GAMMA, ("ToyPlan", "gamma", "repad"): " "}
    findings = check_plan_lifecycle(root, _toy_contract(), exemptions)
    assert [f.rule for f in findings] == ["PL005"]


def test_the_ports_contracts_point_at_the_ports_tree():
    for c in DEFAULT_CONTRACTS:
        assert c.dataclass_path.startswith("src/repro_torch/")
        for leg in c.legs:
            assert (REPO / leg.path).is_file(), leg


# --------------------------------------------------------------------- #
# HP: hot-path purity
# --------------------------------------------------------------------- #
def _purity_spec(**kw) -> PuritySpec:
    kw.setdefault("exemptions", {})
    return PuritySpec(entries=(("pkg/hot.py", "step"),),
                      wire_cast_owners=(("pkg/hot.py", "wire_cast"),),
                      subdirs=("pkg",), boundaries={}, **kw)


HOT = """
    import numpy as np
    import torch

    def step(x):
        y = helper(x)
        v = x.item()
        w = float(x[0])
        z = np.asarray(x)
        r = np.random.rand(3)
        if (x > 0).any():
            y = y + 1
        c = x.sum().cpu()
        torch.cuda.synchronize()
        return y + v + w + z + r + c

    def helper(x):
        a = x.to(torch.bfloat16)
        return a + x.half()

    def wire_cast(x):
        return x.to(dtype=torch.bfloat16)

    def cold(x):
        return x.item()
    """


def test_purity_rules_fire_with_exact_spans(tmp_path):
    _write(tmp_path, "pkg/hot.py", HOT)
    findings = check_purity(tmp_path, _purity_spec())
    got = sorted((f.rule, f.path, f.line) for f in findings)
    assert got == sorted([
        ("HP001", "pkg/hot.py", 7),   # x.item()
        ("HP002", "pkg/hot.py", 8),   # float(x[0])
        ("HP004", "pkg/hot.py", 9),   # np.asarray
        ("HP003", "pkg/hot.py", 10),  # np.random
        ("HP005", "pkg/hot.py", 11),  # if (...).any()
        ("HP001", "pkg/hot.py", 13),  # .cpu() of a call's result
        ("HP001", "pkg/hot.py", 14),  # torch.cuda.synchronize()
        ("HP007", "pkg/hot.py", 18),  # .to(torch.bfloat16) in helper
        ("HP007", "pkg/hot.py", 19),  # .half() in helper
    ])
    # wire_cast owns its cast; `cold` is unreachable from the entry
    assert not any(f.line in (22, 25) for f in findings)


def test_purity_exemptions_are_held_both_ways(tmp_path):
    _write(tmp_path, "pkg/hot.py", """
        def step(x):
            return x.tolist()
        """)
    key = ("pkg/hot.py", "step", "HP001")
    assert check_purity(tmp_path, _purity_spec(
        exemptions={key: "the step's one designed sync"})) == []
    empty = check_purity(tmp_path, _purity_spec(exemptions={key: ""}))
    assert [f.rule for f in empty] == ["HP010"]
    stale = check_purity(tmp_path, _purity_spec(exemptions={
        key: "a sync", ("pkg/hot.py", "step", "HP002"): "gone"}))
    assert [f.rule for f in stale] == ["HP009"]
    assert "HP002" in stale[0].message


def test_purity_stops_at_a_host_boundary(tmp_path):
    _write(tmp_path, "pkg/hot.py", """
        def step(x):
            return stage(x) + 1

        def stage(x):
            return x.numpy()
        """)
    assert [f.rule for f in check_purity(tmp_path, _purity_spec())] == \
        ["HP001"]
    spec = _purity_spec()
    spec.boundaries = {("pkg/hot.py", "stage"): "host-side staging"}
    assert check_purity(tmp_path, spec) == []


def test_purity_keeps_no_jit_or_obs_rule(tmp_path):
    """HP006 (static args) and HP008 (obs in traced code) guard hazards
    that eager PyTorch does not have: neither fires."""
    _write(tmp_path, "pkg/hot.py", """
        import functools
        import torch

        @functools.partial(torch.compile, dynamic=False)
        def step(x, obs):
            with obs.span("step/stage"):
                y = x * 2
            obs.count("steps")
            note_hwm_growth(obs, {}, {}, "step")
            return y
        """)
    assert check_purity(tmp_path, _purity_spec()) == []


def test_purity_shape_math_is_clean(tmp_path):
    _write(tmp_path, "pkg/hot.py", """
        import numpy as np
        import torch

        def step(x, caps):
            n = int(x.shape[0] * 1.5)
            m = float(len(caps))
            k = int(x.size(0)) + int(x.numel())
            if n == 0 or np.asarray(caps).any():
                return x
            return torch.zeros((n, k), dtype=x.dtype) + m
        """)
    # np.asarray of the host caps: the rule cannot tell a host array from a
    # tensor; its truth value, a numpy call's, is a host branch
    assert [f.rule for f in check_purity(tmp_path, _purity_spec())] == \
        ["HP004"]


def test_the_ports_step_entries_resolve_and_reach_the_forwards():
    index = ProjectIndex(REPO, subdirs=("src/repro_torch",))
    entries = [index.function(*e) for e in DEFAULT_ENTRIES]
    assert all(e is not None for e in entries), "an entry no longer resolves"
    reached = {f.qualname for f in reachable_functions(
        index, entries, stop=set(HOST_BOUNDARIES))}
    for name in ("gnn_forward", "Trainer._replica_grads", "Trainer._sync_step",
                 "sim_shuffle", "_cooperative_loop", "block_apply",
                 "lm_grads", "all_reduce"):
        assert name in reached, name
    assert "stage_batch" not in reached


def test_mesh_signature_delegates_to_plan_signature():
    import inspect

    from repro_torch.runtime.signature import mesh_signature

    assert "plan_signature(" in inspect.getsource(mesh_signature)


# --------------------------------------------------------------------- #
# KC: kernel contracts
# --------------------------------------------------------------------- #
def _kernel_spec(**kw) -> KernelSpec:
    return KernelSpec(kernel_roots=("kernels",), extra_packages=(),
                      tests_dir="tests", csrc="csrc",
                      card_tests="tests/test_torch_cuda.py",
                      exemptions=kw.pop("exemptions", {}), **kw)


def _good_package(root: Path, name: str = "good") -> None:
    _write(root, f"kernels/{name}/kernel.py", f"""
        from build import typed_library

        def launch(x):
            return typed_library("{name}", {{}}).{name}(x)
        """)
    _write(root, f"kernels/{name}/ops.py", "def op():\n    pass\n")
    _write(root, f"kernels/{name}/ref.py", "def ref():\n    pass\n")
    _write(root, f"csrc/{name}.cu", "// kernel\n")


def test_kernel_contract_missing_pieces(tmp_path):
    _good_package(tmp_path)
    _write(tmp_path, "tests/test_torch_good.py", """
        from kernels.good.ops import op
        def test_eq():
            assert_close(1, 1, rtol=1e-5, atol=1e-6)
        """)
    _write(tmp_path, "tests/test_torch_cuda.py", """
        import pytest
        from kernels.good import kernel
        """)
    _write(tmp_path, "kernels/bad/ops.py", """
        from build import typed_library
        LIB = typed_library("missing_source", {})
        """)
    findings = check_kernel_contract(tmp_path, _kernel_spec())
    got = {(f.rule, f.path) for f in findings}
    assert got == {
        ("KC001", "kernels/bad"),  # no ref.py
        ("KC005", "kernels/bad"),  # no kernel.py
        ("KC003", "kernels/bad"),  # no tolerance-pinned test
        ("KC006", "kernels/bad/ops.py"),  # csrc/missing_source.cu
        ("KC007", "kernels/bad"),  # no card test
    }
    kc6 = [f for f in findings if f.rule == "KC006"][0]
    assert kc6.line == 3 and "missing_source" in kc6.message


def test_kernel_contract_test_without_tolerance_does_not_count(tmp_path):
    _good_package(tmp_path, "k")
    _write(tmp_path, "tests/test_torch_k.py", """
        from kernels.k.ops import op
        def test_runs():
            assert op() is None
        """)
    # a JAX-side test module does not count for the port
    _write(tmp_path, "tests/test_k.py", """
        from kernels.k.ops import op
        def test_eq():
            assert_close(1, 1, rtol=1e-5)
        """)
    _write(tmp_path, "tests/test_torch_cuda.py", "from kernels.k import kernel\n")
    findings = check_kernel_contract(tmp_path, _kernel_spec())
    assert [f.rule for f in findings] == ["KC003"]


def test_kernel_contract_low_precision_accumulator(tmp_path):
    _good_package(tmp_path, "k")
    _write(tmp_path, "tests/test_torch_k.py",
           "from kernels.k.ops import op\ndef t():\n    f(rtol=1e-5)\n")
    _write(tmp_path, "tests/test_torch_cuda.py", "from kernels.k import kernel\n")
    _write(tmp_path, "kernels/k/ops.py", """
        import torch

        def body(x):
            acc = torch.zeros((8, 128), dtype=torch.bfloat16)
            out = torch.zeros((8, 128), dtype=torch.float32)
            return acc + out
        """)
    findings = check_kernel_contract(tmp_path, _kernel_spec())
    assert [(f.rule, f.path, f.line) for f in findings] == [
        ("KC004", "kernels/k/ops.py", 5)]


def test_kernel_contract_exemptions_are_held_both_ways(tmp_path):
    _good_package(tmp_path, "k")
    (tmp_path / "kernels/k/ref.py").unlink()
    _write(tmp_path, "tests/test_torch_k.py",
           "from kernels.k.ops import op\ndef t():\n    f(atol=0)\n")
    _write(tmp_path, "tests/test_torch_cuda.py", "from kernels.k import kernel\n")
    key = ("kernels/k", "KC001")
    assert check_kernel_contract(tmp_path, _kernel_spec(
        exemptions={key: "the plain version lives in ops.py"})) == []
    assert [f.rule for f in check_kernel_contract(
        tmp_path, _kernel_spec(exemptions={key: ""}))] == ["KC009"]
    stale = check_kernel_contract(tmp_path, _kernel_spec(exemptions={
        key: "in ops.py", ("kernels/k", "KC002"): "gone"}))
    assert [f.rule for f in stale] == ["KC008"]


# --------------------------------------------------------------------- #
# baseline mechanics
# --------------------------------------------------------------------- #
def test_baseline_split_new_suppressed_stale():
    f1 = Finding("a.py", 3, "HP001", "x.item() somewhere")
    f2 = Finding("b.py", 9, "KC003", "no test")
    base = Baseline.from_findings([f1], reason="parked")
    new, suppressed, stale = base.split([f1, f2])
    assert new == [f2] and suppressed == [f1] and stale == []
    drifted = Finding("a.py", 30, "HP001", "x.item() somewhere")
    new, suppressed, stale = base.split([drifted])
    assert new == [] and len(suppressed) == 1
    new, suppressed, stale = base.split([f2])
    assert [e["message"] for e in stale] == ["x.item() somewhere"]


def test_baseline_roundtrip_and_version_gate(tmp_path):
    f = Finding("a.py", 1, "PL001", "msg")
    path = tmp_path / "baseline.json"
    Baseline.from_findings([f], reason="r").save(path)
    assert Baseline.load(path).entries[0]["rule"] == "PL001"
    path.write_text('{"version": 99, "findings": []}')
    with pytest.raises(ValueError, match="version"):
        Baseline.load(path)


# --------------------------------------------------------------------- #
# FT: fault handling
# --------------------------------------------------------------------- #
def test_ft001_swallowing_handlers_fire(tmp_path):
    _write(tmp_path, "pkg/worker.py", """\
        class Worker:
            def poll(self):
                try:
                    torch.cuda.synchronize()
                except RuntimeError:
                    return None

        def drain():
            try:
                step()
            except:
                pass
        """)
    findings = check_faults(tmp_path, FaultSpec(subdirs=("pkg",)))
    assert [f.rule for f in findings] == ["FT001", "FT001"]
    assert "except RuntimeError in Worker.poll" in findings[0].message
    assert "bare except in drain" in findings[1].message
    assert "retry_call" in findings[0].hint


def test_ft001_compliant_handlers_are_clean(tmp_path):
    _write(tmp_path, "pkg/ok.py", """\
        def reraises():
            try:
                step()
            except ValueError:
                raise RuntimeError("wrapped")

        def delivers(self):
            try:
                step()
            except BaseException as e:
                self.err = e

        def counts(self):
            try:
                step()
            except OSError:
                self.stats.failures += 1

        def routes(self):
            try:
                step()
            except KeyError:
                obs.count("fault/misses", 1)

        def logs(self):
            try:
                step()
            except TimeoutError:
                log.warning("timed out")

        def exempted():
            try:
                step()
            except Exception:  # FT001: feature probe, absence is the answer
                return None
        """)
    assert check_faults(tmp_path, FaultSpec(subdirs=("pkg",))) == []


def test_ft001_binding_without_reading_still_fires(tmp_path):
    _write(tmp_path, "pkg/bound.py", """\
        def f():
            try:
                step()
            except ValueError as e:
                return 0
        """)
    findings = check_faults(tmp_path, FaultSpec(subdirs=("pkg",)))
    assert [f.rule for f in findings] == ["FT001"]
    assert "except ValueError in f" in findings[0].message


def test_ft001_covers_the_ports_subtrees():
    assert FaultSpec().subdirs == (
        "src/repro_torch/runtime", "src/repro_torch/faults",
        "src/repro_torch/launch/spmd.py")
    for sub in FaultSpec().subdirs:
        assert (REPO / sub).exists(), sub


# --------------------------------------------------------------------- #
# the real tree, the CLI, and what the checkers import
# --------------------------------------------------------------------- #
def test_real_tree_is_clean_inprocess(capsys):
    """``python -m repro_torch.analysis``'s ``main`` over the port's tree:
    exit 0, every family clean (a finding would be printed with its
    file:line, rule and hint)."""
    from repro_torch.analysis.__main__ import main

    code = main(["--root", str(REPO), "--no-baseline"])
    out = capsys.readouterr().out
    assert code == 0, out
    assert f"clean: {','.join(FAMILIES)}" in out


def test_every_exemption_carries_a_reason():
    from repro_torch.analysis import exemptions as ex

    for table in (ex.PLAN_LIFECYCLE_EXEMPTIONS, ex.HOT_PATH_EXEMPTIONS,
                  ex.KERNEL_CONTRACT_EXEMPTIONS):
        assert table and all(str(r).strip() for r in table.values())


def test_cli_clean_run_and_exit_codes(tmp_path, capsys):
    """``python -m repro_torch.analysis``'s ``main`` (whose return value is
    the exit code) gives 2 for an unknown family, 1 for a tree with a
    finding and 0 once the finding is in a baseline."""
    from repro_torch.analysis.__main__ import main

    assert main(["--root", str(tmp_path), "--select", "BOGUS"]) == 2
    assert "unknown rule families: BOGUS" in capsys.readouterr().err
    _write(tmp_path, "src/repro_torch/faults/bad.py", """\
        def f():
            try:
                step()
            except:
                pass
        """)
    capsys.readouterr()
    assert main(["--root", str(tmp_path), "--select", "FT"]) == 1
    assert "FT001" in capsys.readouterr().out
    assert main(["--root", str(tmp_path), "--select", "FT",
                 "--write-baseline"]) == 0
    assert main(["--root", str(tmp_path), "--select", "FT"]) == 0
    assert "suppressed" in capsys.readouterr().out


def test_the_checkers_import_nothing_they_check():
    """stdlib and the package's own modules only: no torch, numpy, jax or
    anything else of either package."""
    stdlib = set(sys.stdlib_module_names)
    for path in sorted((SRC / "repro_torch" / "analysis").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top in stdlib or name.startswith(
                    "repro_torch.analysis"), (path.name, name)
    assert set(FAMILIES) == {"PL", "HP", "KC", "FT"}
