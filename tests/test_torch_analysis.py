"""repro_torch.analysis: every port rule fires on its violating fixture
(``tests/fixtures/analysis_torch/``) and stays silent on its clean twin;
suppressions, baselines and the CLI contract (exit codes, JSON, the
committed empty baseline); and two injection drills on scratch copies of
port files: a stale alias read after ``aio_absorb`` in
``topology/edge.py``, and a ``build.Entry`` whose argtypes drop one
``c_int64`` in ``kernels/aio_agg.py``.  The checker needs neither torch
nor JAX, and imports neither ``repro`` nor ``jax``."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import run_analysis
from repro_torch.analysis.baseline import (DEFAULT_BASELINE, apply_baseline,
                                           load_baseline, save_baseline)
from repro_torch.analysis.engine import collect_files
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures" / "analysis_torch"
PORT = REPO / "src" / "repro_torch"

RULE_IDS = ("read-after-inplace", "entry-signature", "unseeded-randomness",
            "unguarded-telemetry", "kernel-oracle-pairing",
            "unbounded-telemetry")


def _scan(paths, rule_id=None):
    rules = [RULES_BY_ID[rule_id]] if rule_id else None
    return run_analysis([str(p) for p in paths], rules=rules,
                        root=str(REPO))


def _cli(*args, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *[str(a) for a in args]],
                          cwd=cwd, env=env, capture_output=True,
                          text=True)


# ---------------------------------------------------------------- rules

def test_registry_covers_the_contracted_rules():
    assert [r.id for r in ALL_RULES] == list(RULE_IDS)
    assert {r.id: r.scope for r in ALL_RULES}["entry-signature"] \
        == "project"


@pytest.mark.parametrize("rule_id,bad,clean,min_hits", [
    ("read-after-inplace", "inplace_bad.py", "inplace_clean.py", 4),
    ("unseeded-randomness", "randomness_bad.py", "randomness_clean.py",
     9),
    ("unguarded-telemetry", "orchestrator/telemetry_bad.py",
     "orchestrator/telemetry_clean.py", 4),
    ("unbounded-telemetry", "telemetry/unbounded_bad.py",
     "telemetry/unbounded_clean.py", 3),
    ("entry-signature", "entry_bad/kernels/widget.py",
     "entry_clean/kernels/widget.py", 5),
])
def test_rule_fires_and_stays_silent(rule_id, bad, clean, min_hits):
    hits = _scan([FIX / bad], rule_id)
    assert len(hits) >= min_hits
    assert all(f.rule == rule_id for f in hits)
    assert _scan([FIX / clean], rule_id) == []


def test_randomness_flags_each_global_generator_use():
    msgs = [f.message for f in _scan([FIX / "randomness_bad.py"],
                                     "unseeded-randomness")]
    for needle in ("`torch.rand(...)`", "`randn(...)`", "`.normal_(...)`",
                   "`torch.randint(...)`", "`torch.manual_seed(...)`",
                   "`torch.cuda.manual_seed_all(...)`",
                   "`np.random.rand(...)`", "`random.random(...)`",
                   "wall-clock `time.time()`"):
        assert sum(needle in m for m in msgs) == 1, needle


def test_entry_signature_names_each_fault():
    msgs = [f.message for f in _scan([FIX / "entry_bad/kernels/widget.py"],
                                     "entry-signature")]
    assert any("argtypes ('c_void_p', 'c_void_p', 'c_float') do not "
               "match" in m for m in msgs)
    assert any("does not define" in m for m in msgs)
    assert any("passes 4 argument(s)" in m and "takes 5" in m
               for m in msgs)
    assert any("non-const pointer 0" in m for m in msgs)
    assert any("fresh output `fresh` to the const pointer 1" in m
               for m in msgs)


def test_kernel_oracle_pairing_fires_without_ref():
    hits = _scan([FIX / "pairing_bad/kernels/widget.py"],
                 "kernel-oracle-pairing")
    assert len(hits) == 1
    assert "no sibling kernels/ref.py" in hits[0].message


def test_kernel_oracle_pairing_silent_with_plain_version():
    files = [FIX / "pairing_clean/kernels/widget.py",
             FIX / "pairing_clean/kernels/ref.py"]
    assert _scan(files, "kernel-oracle-pairing") == []


def test_kernel_oracle_pairing_requires_a_gpu_test(tmp_path):
    """With test files in the scanned set, a kernel that no test file
    marked ``gpu`` names is flagged even when its plain version
    exists; a marked file that names it clears the finding."""
    pkg = tmp_path / "kernels"
    pkg.mkdir()
    shutil.copy(FIX / "pairing_clean/kernels/widget.py", pkg)
    shutil.copy(FIX / "pairing_clean/kernels/ref.py", pkg)
    other = tmp_path / "test_other.py"
    other.write_text("from kernels import widget\n"
                     "def test_nothing():\n"
                     "    assert callable(widget.widget_double)\n")
    files = [pkg / "widget.py", pkg / "ref.py", other]
    hits = _scan(files, "kernel-oracle-pairing")
    assert len(hits) == 1 and "marked `gpu`" in hits[0].message
    other.write_text("import pytest\n"
                     "from kernels import widget\n"
                     "pytestmark = pytest.mark.gpu\n"
                     "def test_nothing():\n"
                     "    assert callable(widget.widget_double)\n")
    assert _scan(files, "kernel-oracle-pairing") == []


def test_port_kernels_are_all_exported_and_paired():
    """Every launching wrapper of the port is an exported kernel, the
    ``_flat`` segment-table wrappers included, and each pairs with a
    plain version in ``kernels/ref.py`` and a card test."""
    from repro_torch.analysis.rules import kernel_oracle
    files = collect_files([str(PORT / "kernels"),
                           str(REPO / "tests" / "test_torch_cuda.py")],
                          root=str(REPO))
    names = {n for s in files if kernel_oracle.is_kernels_module(s)
             for n, _ in kernel_oracle.exported_kernels(s)}
    assert names == {"aio_aggregate", "aio_absorb", "aio_merge",
                     "kernel_sumsq", "kernel_l2", "kernel_sumsq_flat",
                     "kernel_l2_flat", "threshold_apply",
                     "threshold_apply_flat", "prob_quantize",
                     "fused_sparsify_quantize",
                     "fused_sparsify_quantize_flat"}
    assert run_analysis([str(s.path) for s in files], root=str(REPO)) == []


# ---------------------------------------- engine: suppression, baseline

def test_inline_suppression_silences_a_finding(tmp_path):
    f = tmp_path / "snippet.py"
    f.write_text("import torch\n"
                 "def f(n):\n"
                 "    # repro: ignore[unseeded-randomness] justified\n"
                 "    return torch.rand(n)\n")
    assert _scan([f], "unseeded-randomness") == []
    f.write_text("import torch\n"
                 "def f(n):\n"
                 "    return torch.rand(n)\n")
    assert len(_scan([f], "unseeded-randomness")) == 1


def test_suppression_scans_contiguous_comment_block(tmp_path):
    f = tmp_path / "snippet.py"
    f.write_text("import time\n"
                 "def f():\n"
                 "    # repro: ignore[unseeded-randomness] — this is a\n"
                 "    # multi-line justification for the wall clock\n"
                 "    # read below; the tag sits two lines up.\n"
                 "    return time.time()\n")
    assert _scan([f], "unseeded-randomness") == []


def test_parse_error_becomes_a_finding(tmp_path):
    f = tmp_path / "broken.py"
    f.write_text("def f(:\n")
    hits = run_analysis([str(f)], root=str(tmp_path))
    assert [h.rule for h in hits] == ["parse-error"]


def test_fixture_corpora_are_excluded_from_directory_walks():
    files = collect_files([str(REPO / "tests")], root=str(REPO))
    assert not any("fixtures/analysis" in s.relpath for s in files)
    explicit = collect_files([str(FIX / "inplace_bad.py")],
                             root=str(REPO))
    assert len(explicit) == 1


def test_baseline_roundtrip_grandfathers_and_reports_stale(tmp_path):
    hits = _scan([FIX / "randomness_bad.py"], "unseeded-randomness")
    bl = tmp_path / "bl.json"
    save_baseline(str(bl), hits)
    base = load_baseline(str(bl))
    new, old, stale = apply_baseline(hits, base)
    assert new == [] and len(old) == len(hits) and not stale
    # fixing one finding leaves a stale entry; a fresh one is new
    new, old, stale = apply_baseline(hits[1:], base)
    assert new == [] and sum(stale.values()) == 1
    fresh = _scan([FIX / "inplace_bad.py"], "read-after-inplace")
    new, old, _ = apply_baseline(hits + fresh, base)
    assert new == fresh


def test_line_shifts_do_not_churn_baseline_keys(tmp_path):
    f = tmp_path / "snippet.py"
    f.write_text("import torch\n"
                 "def f(n):\n"
                 "    return torch.randn(n)\n")
    before = run_analysis([str(f)], root=str(tmp_path))
    f.write_text("import torch\n\n\n"
                 "def f(n):\n"
                 "    return torch.randn(n)\n")
    after = run_analysis([str(f)], root=str(tmp_path))
    assert [x.key() for x in before] == [x.key() for x in after]
    assert before[0].line != after[0].line


def test_committed_baseline_is_empty():
    assert DEFAULT_BASELINE == "ANALYSIS_BASELINE_TORCH.json"
    assert sum(load_baseline(str(REPO / DEFAULT_BASELINE)).values()) == 0


# ------------------------------------------------------------------ CLI

def test_cli_lists_all_rules():
    p = _cli("--list-rules")
    assert p.returncode == 0
    for rid in RULE_IDS:
        assert rid in p.stdout


def test_cli_port_tests_and_smoke_script_pass_against_committed_baseline():
    p = _cli("src/repro_torch", "tests", "chip_smoke.py", "--baseline")
    assert p.returncode == 0, p.stdout + p.stderr
    p = _cli("src/repro_torch", "tests", "--baseline")
    assert p.returncode == 0, p.stdout + p.stderr


def test_cli_exit_one_and_json_on_findings():
    p = _cli(FIX / "inplace_bad.py", "--format", "json")
    assert p.returncode == 1
    doc = json.loads(p.stdout)
    assert doc["findings"] and all(
        f["rule"] == "read-after-inplace" for f in doc["findings"])


def test_cli_unknown_rule_is_usage_error():
    p = _cli("--rule", "no-such-rule", "src/repro_torch")
    assert p.returncode == 2


def test_cli_missing_baseline_is_usage_error(tmp_path):
    p = _cli(FIX / "inplace_clean.py", "--baseline", tmp_path / "none.json")
    assert p.returncode == 2


def test_cli_write_baseline_then_clean(tmp_path):
    bl = tmp_path / "bl.json"
    p = _cli(FIX / "randomness_bad.py", "--write-baseline", bl)
    assert p.returncode == 0
    p = _cli(FIX / "randomness_bad.py", "--baseline", bl)
    assert p.returncode == 0
    p = _cli(FIX / "randomness_bad.py", FIX / "inplace_bad.py",
             "--baseline", bl)
    assert p.returncode == 1


def test_checker_imports_neither_torch_nor_jax_nor_the_reference():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'repro', 'torch'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "from repro_torch.analysis.__main__ import main\n"
            "sys.exit(main(['--list-rules']))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True)
    assert p.returncode == 0, p.stderr


# ------------------------------------------- acceptance: injected bugs

def _kernels_copy(tmp_path):
    pkg = tmp_path / "kernels"
    (pkg / "csrc").mkdir(parents=True)
    for name in ("aio_agg.py", "ref.py", "csrc/aio_agg.cu"):
        shutil.copy(PORT / "kernels" / name, pkg / name)
    return pkg / "aio_agg.py"


def test_injected_read_after_inplace_is_caught(tmp_path):
    scratch = tmp_path / "topology"
    scratch.mkdir()
    dst = scratch / "edge.py"
    shutil.copy(PORT / "topology" / "edge.py", dst)
    with open(dst, "a") as fh:
        fh.write("\n\ndef _injected(num, den, u, m, w):\n"
                 "    before = num\n"
                 "    ops.aio_absorb_op(num, den, u, m, w)\n"
                 "    return num - before\n")
    p = _cli(dst)
    assert p.returncode == 1
    assert "read-after-inplace" in p.stdout
    assert "`before` is a plain alias of `num`, which `aio_absorb_op`" \
        in p.stdout


def test_injected_entry_argtypes_drop_is_caught(tmp_path):
    dst = _kernels_copy(tmp_path)
    text = dst.read_text()
    old = ("ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64))")
    assert text.count(old) == 1
    dst.write_text(text.replace(old, "ctypes.c_void_p, ctypes.c_int64))"))
    p = _cli(dst.parent)
    assert p.returncode == 1
    assert "entry-signature" in p.stdout
    assert "`_AGGREGATE`'s argtypes" in p.stdout


def test_unmodified_scratch_copies_are_clean(tmp_path):
    """The drills above prove detection, not pre-existing noise: pristine
    copies of the same files scan clean."""
    d = tmp_path / "topology"
    d.mkdir()
    shutil.copy(PORT / "topology" / "edge.py", d / "edge.py")
    p = _cli(d / "edge.py")
    assert p.returncode == 0, p.stdout
    p = _cli(_kernels_copy(tmp_path).parent)
    assert p.returncode == 0, p.stdout
