"""The memory planner in the port, held to the JAX package: 10 of the 11
tests of tests/test_planner.py (test_forced_oom_surfaces_budget_error_with_plan
drives bench.py, which the port's bench, ROADMAP A1, will take).

The JAX package compiles each candidate against shape structs and reads
XLA's ``memory_analysis()``; the port bounds each candidate analytically
and measures the rest over one step in a throwaway scope
(``planner._measured_bytes``), so the two packages' byte counts differ by
construction. The twins hold the port to the JAX package's decisions and
structure on the same program and feed: the same ladder, the same
baseline plan when unconstrained, the same stage at a budget both fit,
escalation past stage 0 at a budget between a package's own stage-0 and
stage-1 estimates, and the same errors. ZeRO estimates shrink only when
dp > 1, so the two estimate tests run on a 4-rank gloo world
(``torch_cluster_runner.case_plan_estimates``), as the JAX tests run on 8
virtual devices; the rest run on the CPU in this process. Two tests have
no JAX twin: a measured step that raises ``torch.cuda.OutOfMemoryError``
(injected; the JAX package compiles instead of running) fails its
candidate and the ladder goes on, on one device and on every rank of the
world.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
import torch_dist_runner as R
from torch_cluster_runner import _stage
from paddle_tpu import planner as jplanner
from paddle_tpu.core import unique_name as jnames
from paddle_tpu_torch import planner
from paddle_tpu_torch.core import unique_name as tnames

torch.set_num_threads(1)

N = 4
CPU = tfluid.CPUPlace()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("planner_world")
    live = {}

    def get():
        w = live.get("w")
        if w is None or not w.alive:
            w = live["w"] = R.World(N, tmp, cases="torch_cluster_runner")
        return w

    yield get
    if "w" in live:
        live["w"].close()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    from paddle_tpu_torch.core import program as prog_mod
    from paddle_tpu_torch.core import scope as scope_mod

    old = (prog_mod._main_program, prog_mod._startup_program,
           scope_mod._global_scope, scope_mod._current_scope)
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    scope_mod._global_scope = scope_mod._current_scope = scope_mod.Scope()
    with tnames.guard():
        yield
    (prog_mod._main_program, prog_mod._startup_program,
     scope_mod._global_scope, scope_mod._current_scope) = old


def _model(fluid=tfluid):
    names = jnames if fluid is jfluid else tnames
    with names.guard():
        main, _startup, loss = R.build_zero_mlp(fluid, "adam")
    return main, R.zero_mlp_feed(), loss


# -- estimation (dp = 4) -------------------------------------------------------

def _world_estimates(world, budget=None):
    feed = R.zero_mlp_feed()
    got = world().run("plan_estimates", [dict(
        feed=R.rows(feed, r, N), budget=budget) for r in range(N)])
    for r in got[1:]:
        assert r == got[0]  # the group's largest, on every rank
    return got[0]


def test_measured_estimates_shrink_with_stage3(world):
    est = _world_estimates(world)["est"]
    assert est[0]["source"] == "measured" and est[3]["source"] == "measured"
    assert est[3]["est_bytes_per_device"] < est[0]["est_bytes_per_device"]
    # as the JAX package's estimates shrink on its 8-device mesh
    main, feed, loss = _model(jfluid)
    j0 = jplanner.estimate_plan(jplanner.Plan(0, "none", 1), main, feed, loss)
    j3 = jplanner.estimate_plan(jplanner.Plan(3, "none", 1), main, feed, loss)
    assert j3.est_bytes_per_device < j0.est_bytes_per_device


def test_ladder_escalates_to_first_fit(world):
    est = _world_estimates(world)["est"]
    p0, p1 = est[0]["est_bytes_per_device"], est[1]["est_bytes_per_device"]
    assert p1 < p0
    mid = (p0 + p1) // 2
    plan = _world_estimates(world, budget=mid)["chosen"]
    assert plan["stage"] >= 1 and plan["fits"]
    assert plan["est_bytes_per_device"] <= mid
    # the JAX package escalates the same way between its own estimates
    main, feed, loss = _model(jfluid)
    j0 = jplanner.estimate_plan(jplanner.Plan(0, "none", 1), main, feed, loss)
    j1 = jplanner.estimate_plan(jplanner.Plan(1, "none", 1), main, feed, loss)
    jplan = jplanner.plan_for(main, feed, loss, budget_bytes=(
        j0.est_bytes_per_device + j1.est_bytes_per_device) // 2)
    assert (jplan.stage, jplan.remat, jplan.microbatch) == (
        plan["stage"], plan["remat"], plan["microbatch"])


def test_oom_on_one_rank_fails_the_candidate_on_every_rank(world):
    """A measured step that runs out of device memory on one rank: the
    failed flag rides the group's all-reduce, so every rank marks stage 0
    as not fitting and every rank escalates to the same plan."""
    feed = R.zero_mlp_feed()
    got = world().run("plan_estimates", [dict(
        feed=R.rows(feed, r, N), stages=(0,), budget=1 << 30, oom_rank=1)
        for r in range(N)])
    for r, res in enumerate(got):
        p0 = res["est"][0]
        assert not p0["fits"] and p0["source"] == "measured", (r, p0)
        assert p0["error"].startswith("OutOfMemoryError"), (r, p0)
        assert res["chosen"]["stage"] == 1 and res["chosen"]["fits"], r
        assert res["chosen"]["est_bytes_per_device"] == \
            got[0]["chosen"]["est_bytes_per_device"]
    assert "Tried to allocate" in got[1]["est"][0]["error"]
    assert "another rank" in got[0]["est"][0]["error"]


# -- one device -----------------------------------------------------------------

def test_oom_step_escalates_past_the_candidate(monkeypatch):
    """A candidate whose measured step raises torch.cuda.OutOfMemoryError
    does not fit: its error is kept, its estimate is over the budget, and
    the ladder goes on to the next candidate. Other errors pass."""
    main, feed, loss = _model()
    real = tfluid.Executor.run
    calls = []

    def run(self, program, *a, **kw):
        if _stage(program) == 0:
            calls.append(kw.get("scope"))
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        return real(self, program, *a, **kw)

    monkeypatch.setattr(tfluid.Executor, "run", run)
    budget = 1 << 30
    plan = planner.plan_for(main, feed, loss, budget_bytes=budget,
                            place=CPU)
    assert (plan.stage, plan.remat, plan.microbatch) == (1, "none", 1)
    assert plan.fits and plan.error is None and plan.source == "measured"
    first = planner._last_candidates[0]
    assert (first.stage, first.fits, first.source) == (0, False, "measured")
    assert first.error.startswith("OutOfMemoryError: CUDA out of memory")
    assert first.est_bytes_per_device > budget
    assert len(calls) == 1 and calls[0] is not None  # its throwaway scope
    # the whole ladder out of memory: the structured error, every error kept

    def oom(self, program, *a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(tfluid.Executor, "run", oom)
    with pytest.raises(planner.HbmBudgetError) as ei:
        planner.plan_for(main, feed, loss, budget_bytes=budget, place=CPU)
    assert len(ei.value.candidates) >= 6
    assert all(p.error and not p.fits and p.est_bytes_per_device > budget
               for p in ei.value.candidates)

    def boom(self, program, *a, **kw):
        raise ValueError("not a memory problem")

    monkeypatch.setattr(tfluid.Executor, "run", boom)
    with pytest.raises(ValueError):
        planner.plan_for(main, feed, loss, budget_bytes=budget, place=CPU)


def test_unconstrained_returns_baseline_without_compiling():
    main, feed, loss = _model()
    plan = planner.plan_for(main, feed, loss, budget_bytes=None, place=CPU)
    assert (plan.stage, plan.remat, plan.microbatch) == (0, "none", 1)
    assert plan.source == "unconstrained" and plan.fits
    assert plan.est_bytes_per_device is None  # nothing was run
    # the CPU has no allocator stats, so no budget of its own
    from paddle_tpu_torch.observability.memory import device_memory_stats
    assert device_memory_stats("cpu") is None
    assert planner.resolve_budget_bytes(CPU) is None
    jmain, jfeed, jloss = _model(jfluid)
    jplan = jplanner.plan_for(jmain, jfeed, jloss, budget_bytes=None)
    assert plan.to_dict() == jplan.to_dict()


def test_no_fit_raises_structured_error():
    main, feed, loss = _model()
    with pytest.raises(planner.HbmBudgetError) as ei:
        planner.plan_for(main, feed, loss, budget_bytes=64, place=CPU)
    err = ei.value
    assert err.plan is not None                      # best-found attached
    assert err.plan.est_bytes_per_device is not None
    assert len(err.candidates) >= 6                  # whole ladder walked
    # best-found is the min-estimate candidate; every bound was over 64
    # bytes, so nothing ran
    assert err.plan.est_bytes_per_device == min(
        p.est_bytes_per_device for p in err.candidates)
    assert all(p.source == "analytic" for p in err.candidates)
    assert "best found" in str(err)
    # the JAX package's ladder for this batch on one device (its plan_for
    # takes dp from its 8 test devices, the port's from the world of 1)
    assert [(p.stage, p.remat, p.microbatch) for p in err.candidates] == [
        (p.stage, p.remat, p.microbatch)
        for p in jplanner.default_candidates(batch=32, dp=1)]
    jmain, jfeed, jloss = _model(jfluid)
    with pytest.raises(jplanner.HbmBudgetError):
        jplanner.plan_for(jmain, jfeed, jloss, budget_bytes=64)


def test_microbatch_candidates_respect_divisibility():
    for batch, dp in ((12, 4), (32, 4), (32, 8), (None, 1), (6, 1)):
        got = [(p.stage, p.remat, p.microbatch)
               for p in planner.default_candidates(batch=batch, dp=dp)]
        want = [(p.stage, p.remat, p.microbatch)
                for p in jplanner.default_candidates(batch=batch, dp=dp)]
        assert got == want, (batch, dp)
    cands = planner.default_candidates(batch=12, dp=4)
    assert [p.microbatch for p in cands if p.microbatch > 1] == []
    cands = planner.default_candidates(batch=32, dp=4)
    assert [p.microbatch for p in cands if p.microbatch > 1] == [2, 4, 8]


# -- observability ---------------------------------------------------------------

def test_plan_recorded_in_registry_and_flight():
    from paddle_tpu_torch.observability.flight import (_collect_sections,
                                                       get_flight_recorder)
    from paddle_tpu_torch.observability.registry import get_registry

    main, feed, loss = _model()
    plan = planner.plan_for(main, feed, loss, budget_bytes=1 << 30,
                            place=CPU)
    assert plan.source == "measured" and plan.est_bytes_per_device > 0
    snap = get_registry().snapshot(deep=True)
    assert snap["planner/chosen_stage"] == plan.stage
    assert snap["planner/chosen_microbatch"] == plan.microbatch
    assert snap["planner/est_bytes_per_device"] == plan.est_bytes_per_device
    assert snap["planner/budget_bytes"] == float(1 << 30)
    sec = _collect_sections()["hbm_plan"]
    assert sec["chosen"]["stage"] == plan.stage
    assert any(c["fits"] for c in sec["candidates"])
    evs = [e for e in get_flight_recorder().contents()["events"]
           if e["message"] == "hbm_plan"]
    assert evs and evs[-1]["stage"] == plan.stage
    assert planner.last_plan() is plan
    jmain, jfeed, jloss = _model(jfluid)
    jplan = jplanner.plan_for(jmain, jfeed, jloss, budget_bytes=1 << 30)
    assert (jplan.stage, jplan.remat, jplan.microbatch) == (
        plan.stage, plan.remat, plan.microbatch)


@pytest.mark.parametrize("error", [
    RuntimeError("RESOURCE_EXHAUSTED: 2.5G over budget"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                "2.50 GiB")])
def test_guard_converts_oom_to_budget_error(error):
    main, feed, loss = _model()
    plan = planner.plan_for(main, feed, loss, budget_bytes=1 << 30,
                            place=CPU)
    with pytest.raises(planner.HbmBudgetError) as ei:
        with planner.guard("test/guard", plan=plan):
            raise error
    assert ei.value.plan is plan
    assert str(error)[:20] in str(ei.value)
    assert ei.value.__cause__ is error


def test_guard_passes_non_oom_through():
    with pytest.raises(ValueError):
        with planner.guard("test/guard"):
            raise ValueError("not a memory problem")
    with pytest.raises(ValueError):
        with jplanner.guard("test/guard"):
            raise ValueError("not a memory problem")


# -- CLI ---------------------------------------------------------------------------

def test_hbm_plan_cli_json(capsys):
    from paddle_tpu_torch.tools import hbm_plan

    code = hbm_plan.main(["--model", "mlp", "--batch", "8",
                          "--budget", "1e9", "--json", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0
    assert out["fits"] is True
    assert out["chosen"]["source"] == "measured"
    assert out["chosen"]["est_bytes_per_device"] > 0
    from paddle_tpu.tools import hbm_plan as jtool

    assert jtool.main(["--model", "mlp", "--batch", "8", "--budget", "1e9",
                       "--json"]) == code
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("stage", "remat", "microbatch", "fits"):
        assert out["chosen"][k] == jout["chosen"][k]


def test_hbm_plan_cli_no_fit_exit_code(capsys):
    from paddle_tpu_torch.tools import hbm_plan

    code = hbm_plan.main(["--model", "mlp", "--budget", "64", "--json",
                          "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 2
    assert out["fits"] is False
    assert out["chosen"] is not None  # best-found plan still reported
    assert len(out["candidates"]) >= 6
    assert np.isfinite(out["chosen"]["est_bytes_per_device"])
