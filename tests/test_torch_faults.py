"""The port's chaos harness (``paddle_tpu_torch.faults``) against the JAX
package's (``paddle_tpu.faults``): twins of ``tests/test_faults.py``.

Each case runs the same spec, hits and files through both harnesses and
requires the same rules, the same firings and exceptions, and (for the
``corrupt`` action) the same bytes flipped. Exact equality throughout:
the harness is deterministic by hit count."""
import os
import subprocess
import sys
import time

import pytest

from paddle_tpu import faults as jfaults
from paddle_tpu.observability import get_registry as jregistry
from paddle_tpu_torch import faults
from paddle_tpu_torch.observability import get_registry

BOTH = [pytest.param(jfaults, jregistry, id="jax"),
        pytest.param(faults, get_registry, id="port")]


@pytest.fixture(autouse=True)
def _clean_harness():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


class TestSpecGrammar:
    def test_full_grammar_roundtrip(self):
        spec = ("ckpt.shard_write:crash@2, loader.next:delay_ms=50,"
                "ckpt.bundle_write:corrupt")
        got = [repr(r) for r in faults.parse_spec(spec)]
        assert got == [repr(r) for r in jfaults.parse_spec(spec)]
        assert got == ["ckpt.shard_write:crash@2", "loader.next:delay_ms=50",
                       "ckpt.bundle_write:corrupt"]

    @pytest.mark.parametrize("bad,msg", [
        ("ckpt.rename", "site:action"),
        ("ckpt.rename:explode", "unknown"),
        ("ckpt.rename:crash@x", "not an integer"),
        ("ckpt.rename:crash@0", ">= 1"),
        ("ckpt.rename:delay_ms", "needs a value"),
        ("ckpt.rename:delay_ms=fast", "not a number"),
    ])
    def test_malformed_entries_raise(self, bad, msg):
        for mod in (jfaults, faults):
            with pytest.raises(ValueError, match=msg) as ei:
                mod.parse_spec(bad)
        with pytest.raises(ValueError) as ej:
            jfaults.parse_spec(bad)
        assert str(ei.value) == str(ej.value)

    def test_install_rejects_unknown_action(self):
        for mod in (jfaults, faults):
            with pytest.raises(ValueError, match="unknown fault action"):
                mod.install("x", "explode")


def _trace(mod, site, hits):
    """[None | exception class name] for `hits` probes of `site`."""
    out = []
    for _ in range(hits):
        try:
            mod.fault_point(site)
            out.append(None)
        except mod.InjectedFault as e:
            out.append(type(e).__name__)
    return out


class TestTriggering:
    def test_counted_rule_fires_on_nth_hit_only(self):
        got = {}
        for mod in (jfaults, faults):
            mod.install("t.site", "raise", count=2)
            got[mod] = (_trace(mod, "t.site", 3), mod.hits("t.site"))
        assert got[faults] == got[jfaults] == (
            [None, "InjectedFault", None], 3)

    def test_uncounted_rule_fires_every_hit(self):
        for mod in (jfaults, faults):
            mod.install("t.every", "raise")
            assert _trace(mod, "t.every", 3) == ["InjectedFault"] * 3

    def test_idle_harness_is_a_noop_and_counts_nothing(self):
        for mod in (jfaults, faults):
            mod.fault_point("t.idle")
            assert mod.hits("t.idle") == 0  # counting starts when armed
            assert mod.active_rules() == []

    def test_injected_fault_is_an_oserror(self):
        assert issubclass(faults.InjectedFault, OSError)
        assert issubclass(faults.InjectedNetworkFault, faults.InjectedFault)
        assert faults.CRASH_EXIT_CODE == jfaults.CRASH_EXIT_CODE == 70

    def test_env_spec_arms_and_rearms(self, monkeypatch):
        monkeypatch.setenv("PDTPU_FAULT_SPEC", "t.env:raise@1")
        for mod in (jfaults, faults):
            with pytest.raises(mod.InjectedFault):
                mod.fault_point("t.env")
            assert mod.active_rules() == ["t.env:raise@1"]
        # changing the variable re-parses on the next probe
        monkeypatch.delenv("PDTPU_FAULT_SPEC")
        for mod in (jfaults, faults):
            mod.fault_point("t.env")  # no rules: no-op
            assert mod.active_rules() == []
        # setting it again re-arms the one-shot rule
        monkeypatch.setenv("PDTPU_FAULT_SPEC", "t.env:raise@1")
        for mod in (jfaults, faults):
            mod.clear()
            assert _trace(mod, "t.env", 2) == ["InjectedFault", None]

    @pytest.mark.parametrize("mod,reg", BOTH)
    def test_delay_action_sleeps_and_counts_metric(self, mod, reg):
        c = reg().counter("faults/injected", site="t.slow",
                          action="delay_ms")
        before = c.value
        mod.install("t.slow", "delay_ms", value=40)
        t0 = time.perf_counter()
        mod.fault_point("t.slow")
        assert time.perf_counter() - t0 >= 0.03
        assert c.value == before + 1

    def test_corrupt_action_flips_bytes_in_place(self, tmp_path):
        """Both harnesses flip the same comb of bytes."""
        out = {}
        for mod in (jfaults, faults):
            p = tmp_path / f"{mod.__name__}.bin"
            p.write_bytes(b"\x00" * 4096)
            mod.install("t.rot", "corrupt")
            mod.fault_point("t.rot", path=str(p))
            out[mod] = p.read_bytes()
            assert len(out[mod]) == 4096  # corruption, not truncation
            # pathless probes and missing files are tolerated (no crash)
            mod.fault_point("t.rot")
            mod.fault_point("t.rot", path=str(tmp_path / "missing"))
        assert out[faults] != b"\x00" * 4096
        assert out[faults] == out[jfaults]

    def test_network_actions_raise_with_their_kind(self):
        for mod in (jfaults, faults):
            mod.install("t.net", "drop", count=1)
            mod.install("t.net", "reset", count=2)
            kinds = []
            for _ in range(2):
                with pytest.raises(mod.InjectedNetworkFault) as ei:
                    mod.fault_point("t.net")
                kinds.append(ei.value.kind)
            assert kinds == ["drop", "reset"]

    def test_crash_exits_with_the_crash_code(self):
        """``crash`` is ``os._exit(CRASH_EXIT_CODE)``: no unwinding, so a
        ``finally`` after the probe never prints. The child loads the
        harness under a stub parent (no torch)."""
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        code = (
            "import sys, types\n"
            "stub = types.ModuleType('paddle_tpu_torch')\n"
            f"stub.__path__ = [{os.path.join(root, 'paddle_tpu_torch')!r}]\n"
            "sys.modules['paddle_tpu_torch'] = stub\n"
            "from paddle_tpu_torch import faults\n"
            "try:\n"
            "    faults.fault_point('t.die')\n"
            "finally:\n"
            "    print('unwound')\n")
        env = dict(os.environ, PDTPU_FAULT_SPEC="t.die:crash@1")
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == faults.CRASH_EXIT_CODE, r.stderr
        assert "unwound" not in r.stdout
