"""The port's metric-name lint: twins of tests/test_metrics_lint.py. The
port's package source is lint-clean; the linter's findings on the same
synthetic trees and history segments equal the JAX package's (the port's
copy is the stdlib module); the CLI and ``python -m`` entry point run
clean, the latter without loading torch (bastion tooling)."""
import json
import subprocess
import sys

import pytest

from paddle_tpu.tools import metrics_lint as jlint
from paddle_tpu_torch.tools.metrics_lint import (default_root,
                                                 lint_history_segments,
                                                 lint_source_tree, main,
                                                 scan_file)


def test_package_source_is_lint_clean():
    """THE gate: any metric-name drift in paddle_tpu_torch fails tier-1."""
    root = default_root()
    assert root.endswith("paddle_tpu_torch")
    assert lint_source_tree(root) == []


def _same_tree_findings(tmp_path):
    out = lint_source_tree(str(tmp_path))
    assert out == jlint.lint_source_tree(str(tmp_path))
    return out


def test_scan_finds_literal_registrations(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(
        "reg.counter('a/b').inc()\n"
        "x = reg.gauge(\"c/d\", shard='0')\n"
        "reg.histogram( 'e_f' ).observe(1)\n"
        "def counter(self, name):  # a definition, not a call\n"
        "    pass\n"
        "reg.counter(f'dyn/{name}')  # dynamic: caller's problem\n"
        "reg.counter(name)  # non-literal\n")
    assert scan_file(str(p)) == jlint.scan_file(str(p)) == [
        ("counter", "a/b", 1), ("gauge", "c/d", 2), ("histogram", "e_f", 3)]


def test_lint_flags_illegal_names(tmp_path):
    (tmp_path / "bad.py").write_text(
        "reg.counter('has-dash')\n"
        "reg.gauge('0leading')\n"
        "reg.histogram('ok/name')\n")
    problems = _same_tree_findings(tmp_path)
    assert len(problems) == 2
    assert any("has-dash" in p and "bad.py:1" in p for p in problems)
    assert any("0leading" in p and "bad.py:2" in p for p in problems)


def test_lint_flags_type_conflicts_across_files(tmp_path):
    (tmp_path / "a.py").write_text("reg.counter('x/y')\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.py").write_text("reg.gauge('x/y')\n")
    (problem,) = _same_tree_findings(tmp_path)
    assert "conflicting types" in problem and "'x/y'" in problem


def test_lint_flags_post_sanitization_collisions(tmp_path):
    (tmp_path / "a.py").write_text(
        "reg.counter('x/y')\nreg.counter('x_y')\n")
    (problem,) = _same_tree_findings(tmp_path)
    assert "sanitize to 'x_y'" in problem
    (tmp_path / "a.py").write_text(
        "reg.counter('x/y')\nreg.counter('x/y')\n")
    assert _same_tree_findings(tmp_path) == []


def test_lint_skips_pycache_and_itself(tmp_path):
    (tmp_path / "__pycache__").mkdir()
    (tmp_path / "__pycache__" / "junk.py").write_text(
        "reg.counter('very-bad')\n")
    (tmp_path / "metrics_lint.py").write_text("reg.counter('also-bad')\n")
    assert _same_tree_findings(tmp_path) == []


def test_history_segment_lint_flags_each_contract_break(tmp_path):
    ok = {"t": 1.0, "series": [
        {"name": "a/b", "labels": {"p": "w0"}, "field": "value", "v": 1}]}
    (tmp_path / "history_1_00001.jsonl").write_text(
        json.dumps(ok) + "\n" + "not json\n"
        + json.dumps({"t": 0.5, "series": []}) + "\n"
        + json.dumps({"t": 2.0, "series": [
            {"name": "has-dash", "field": "value", "v": 1},
            {"name": "a/b", "field": "p17", "v": 1},
            {"name": "a/b", "field": "p99", "v": "x"},
            {"name": "a/b", "field": "p50", "v": 1,
             "labels": {"p": 3}}]}) + "\n")
    problems = lint_history_segments(str(tmp_path))
    assert problems == jlint.lint_history_segments(str(tmp_path))
    for needle in ("not valid JSON", "backwards", "has-dash", "p17",
                   "non-numeric", "str->str"):
        assert any(needle in p for p in problems), needle
    (tmp_path / "history_1_00002.jsonl").write_text(
        json.dumps(ok) + "\n" + '{"t": 3.0, "ser')
    assert not any("00002" in p
                   for p in lint_history_segments(str(tmp_path)))


def test_cli_history_mode(tmp_path, capsys):
    (tmp_path / "history_1_00001.jsonl").write_text(
        json.dumps({"t": 1.0, "series": []}) + "\n")
    assert main(["--history", str(tmp_path)]) == 0
    assert "history segments clean" in capsys.readouterr().out
    (tmp_path / "history_1_00001.jsonl").write_text("garbage\ngarbage\n")
    assert main(["--history", str(tmp_path)]) == 1
    assert jlint.main(["--history", str(tmp_path)]) == 1


def test_cli_exit_codes(tmp_path, capsys):
    assert main([str(tmp_path)]) == 0
    assert "clean" in capsys.readouterr().out
    (tmp_path / "bad.py").write_text("reg.counter('has-dash')\n")
    assert main([str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "has-dash" in out and "1 problem(s)" in out


@pytest.mark.parametrize("tool", ["metrics_lint", "postmortem"])
def test_module_entrypoint_runs_without_torch(tool):
    """``python -m paddle_tpu_torch.tools.metrics_lint`` is the CI
    invocation and, like the postmortem CLI, runs on a host without
    torch: the package's ``__init__`` skips the framework surface."""
    args = ["--help"] if tool == "postmortem" else []
    r = subprocess.run(
        [sys.executable, "-m", f"paddle_tpu_torch.tools.{tool}"] + args,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    if tool == "metrics_lint":
        assert "clean" in r.stdout
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.orig_argv = [sys.executable, '-m', "
         f"'paddle_tpu_torch.tools.{tool}']; "
         "import paddle_tpu_torch.tools." + tool + "; "
         "print('torch' in sys.modules)"],
        capture_output=True, text=True, timeout=120)
    assert probe.returncode == 0, probe.stderr
    assert probe.stdout.strip() == "False"
