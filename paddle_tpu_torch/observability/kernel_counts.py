"""What a hand kernel's launch costs, and the kernel's readable name.

The hand kernels (``ops/kernels/*``) are C calls inside
``torch.autograd.Function``s: neither ``torch.utils.flop_counter`` nor a
``TorchDispatchMode`` sees their work, and a ``torch.profiler`` kernel
event carries no byte or flop count. So each kernel module computes a
launch's flops and bytes from its shapes (``fwd_counts``, ``bwd_counts``,
... in the module: the same functions the chip check's bounds read), and
its wrapper reports the launch here with `declare`. Two kinds of
collectors listen: the perf ledger's ``counted`` source (one dispatch of a
plan's first run) and a profiler session (``profiler.start_profiler``,
the profile trigger's capture), which writes what it collected beside its
trace so the roofline join (``tools.roofline.kernel_table``) can give the
kernel rows their counts. With no collector active `declare` returns at
once and the wrapper computes nothing.

A declaration names its row (``"flash_attention_fwd[bf16]"``) and the
base names of the CUDA kernels the launch runs (``flash_fwd_bf16_kernel``;
a backward names its delta, dq and dk/dv kernels). The roofline join
matches a trace's kernel events to a row by those base names: the
kernel's demangled name less its namespace, template arguments and
parameters (`base_name`), the label `kernel_label` prints.

A data-dependent count (the visible key tiles of a sparse launch) may be a
0-dim tensor on the card: the collector sums such counts once, when it is
read (`Declared.totals`), so a launch does not wait on the host.
"""
from __future__ import annotations

import contextlib
import re
import threading
import time
from typing import Dict, Iterable, Optional

__all__ = ["declare", "active", "collect", "Declared", "kernel_label",
           "base_name", "HAND_KERNELS"]

_sinks: list = []
_lock = threading.Lock()

# every __global__ function under csrc/ (the hand kernels)
HAND_KERNELS = (
    "flash_fwd_bf16_kernel", "flash_fwd_f32_kernel",
    "flash_bwd_delta_kernel", "flash_bwd_dq_bf16_kernel",
    "flash_bwd_dkv_bf16_kernel", "flash_bwd_f32_kernel",
    "sparse_fwd_bf16_kernel", "sparse_fwd_f32_kernel",
    "sparse_bwd_bf16_kernel", "sparse_bwd_f32_kernel",
    "wide_fwd_bf16_kernel", "wide_fwd_f32_kernel", "wide_bwd_bf16_kernel",
    "wide_bwd_f32_kernel", "wide_role_f32_kernel",
    "colsum_kernel", "finish_kernel", "apply_kernel", "bwd_dx_kernel",
    "conv_stats_bf16_kernel", "conv_stats_f32_kernel",
    "adagrad_kernel", "gather_kernel", "scatter_kernel")


def active() -> bool:
    """True while some collector listens (a wrapper's cue to count)."""
    return bool(_sinks)


def declare(name: str, kernels: Iterable[str], flops, nbytes) -> None:
    """Report one launch of row `name` running `kernels`, costing `flops`
    and `nbytes` (numbers, or 0-dim tensors) to every active collector."""
    if not _sinks:
        return
    with _lock:
        for sink in _sinks:
            sink.add(name, kernels, flops, nbytes)


class Declared:
    """One collector: row name → kernels, launches, flops and bytes."""

    def __init__(self):
        self._rows: Dict[str, dict] = {}

    def add(self, name, kernels, flops, nbytes) -> None:
        r = self._rows.get(name)
        if r is None:
            r = self._rows[name] = {"kernels": list(kernels), "flops": [],
                                    "bytes": [], "t": []}
        r["flops"].append(flops)
        r["bytes"].append(nbytes)
        r["t"].append(time.time())

    def __bool__(self) -> bool:
        return bool(self._rows)

    @staticmethod
    def _sum(values) -> float:
        tensors = [v for v in values if hasattr(v, "item")]
        total = sum(float(v) for v in values if not hasattr(v, "item"))
        if tensors:
            import torch
            total += float(torch.stack(
                [t.reshape(()).to(torch.float64) for t in tensors]).sum())
        return total

    def totals(self, since: Optional[float] = None,
               until: Optional[float] = None) -> Dict[str, dict]:
        """row → {kernels, calls, flops, bytes} of the launches declared
        between `since` and `until` (wall seconds; all by default). One
        host read for the counts that are tensors."""
        out = {}
        for name, r in self._rows.items():
            keep = [i for i, t in enumerate(r["t"])
                    if (since is None or t >= since)
                    and (until is None or t <= until)]
            if keep:
                out[name] = {"kernels": list(r["kernels"]),
                             "calls": len(keep),
                             "flops": self._sum([r["flops"][i]
                                                 for i in keep]),
                             "bytes": self._sum([r["bytes"][i]
                                                 for i in keep])}
        return out


@contextlib.contextmanager
def collect():
    """Collect the declarations made while the block runs (any thread)."""
    d = Declared()
    with _lock:
        _sinks.append(d)
    try:
        yield d
    finally:
        with _lock:
            _sinks.remove(d)


# -- names -------------------------------------------------------------------

def _strip_call(name: str) -> str:
    """``void ns::f<a, b>(P)`` → ``ns::f<a, b>``."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            c = name[i]
            if c == ")":
                depth += 1
            elif c == "(":
                depth -= 1
                if depth == 0:
                    name = name[:i]
                    break
    return name


def _split_template(name: str):
    """``ns::f<a, b>`` → (``f``, [``a``, ``b``]); no template → []."""
    args = []
    lt = name.find("<")
    head = name if lt < 0 else name[:lt]
    if lt >= 0 and name.endswith(">"):
        depth, cur = 0, ""
        for c in name[lt + 1:-1]:
            if c in "<(":
                depth += 1
            elif c in ">)":
                depth -= 1
            if c == "," and depth == 0:
                args.append(cur.strip())
                cur = ""
            else:
                cur += c
        if cur.strip():
            args.append(cur.strip())
    return head.split("::")[-1], args


def _flag(a: str) -> str:
    a = a.replace("(bool)", "").strip()
    return {"true": "1", "false": "0"}.get(a, a)


def _label_mangled(mangled: str) -> Optional[str]:
    """`kernel_label` of a mangled name (the chip check's reading of
    ptxas and cuobjdump output)."""
    k = re.search(r"((?:flash|sparse)_[fb]wd_\w+?_kernel)ILi(\d+)E"
                  r"(?:Li(\d+)E)?", mangled)
    if k:
        return (f"{k.group(1)}<{k.group(2)}"
                f"{', ' + k.group(3) if k.group(3) else ''}>")
    k = re.search(r"(apply_kernel|bwd_dx_kernel)I(f|13__nv_bfloat16)"
                  r"Lb([01])ELb([01])E", mangled)
    if k:
        return (f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'bf16'}, "
                f"res={k.group(3)}, relu={k.group(4)}>")
    k = re.search(r"conv_stats_f32_kernelILb([01])E", mangled)
    if k:
        return f"conv_stats_f32_kernel<resident W={k.group(1)}>"
    k = re.search(r"conv_stats_bf16_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                  mangled)
    if k:
        return (f"conv_stats_bf16_kernel<BN={k.group(1)}, CTAs/SM="
                f"{k.group(2)}, resident W={k.group(3)} B>")
    k = re.search(r"(wide_[fb]wd_(?:f32|bf16)_kernel)ILb([01])E", mangled)
    if k:
        return f"{k.group(1)}<sparse={k.group(2)}>"
    k = re.search(r"wide_role_f32_kernelILi(\d)ELb([01])E", mangled)
    if k:
        role = ("fwd", "dq", "dk", "dv")[int(k.group(1))]
        return f"wide_role_f32_kernel<{role}, sparse={k.group(2)}>"
    return None


def _is_mangled(name: str) -> bool:
    """An Itanium-mangled symbol, bare or in a section name
    (``.text._ZN...``)."""
    return "_Z" in name and "<" not in name and "(" not in name


def _mangled_base(mangled: str) -> Optional[str]:
    for base in sorted(HAND_KERNELS, key=len, reverse=True):
        if f"{len(base)}{base}" in mangled:
            return base
    return None


def base_name(name: str) -> str:
    """A kernel's name less namespace, template arguments and parameters
    (``void fa::flash_fwd_bf16_kernel<64>(P)`` → ``flash_fwd_bf16_kernel``);
    the name itself where it cannot tell."""
    if _is_mangled(name):
        return _mangled_base(name) or name
    return _split_template(_strip_call(name))[0] or name


def kernel_label(name: str) -> Optional[str]:
    """A readable name of a hand kernel from its mangled or demangled
    name (``flash_fwd_bf16_kernel<64>``,
    ``apply_kernel<bf16, res=0, relu=1>``); None for another kernel (and
    for a mangled hand kernel this reading does not format)."""
    if _is_mangled(name):
        return _label_mangled(name)
    base, args = _split_template(_strip_call(name))
    if base not in HAND_KERNELS:
        return None
    args = [_flag(a) for a in args]
    if re.fullmatch(r"(?:flash|sparse)_[fb]wd_\w+?_kernel", base) \
            and args and all(a.isdigit() for a in args):
        return f"{base}<{', '.join(args[:2])}>"
    if base in ("apply_kernel", "bwd_dx_kernel") and len(args) >= 3:
        dt = "float" if args[0] == "float" else "bf16"
        return f"{base}<{dt}, res={args[1]}, relu={args[2]}>"
    if base == "conv_stats_f32_kernel" and args:
        return f"conv_stats_f32_kernel<resident W={args[0]}>"
    if base == "conv_stats_bf16_kernel" and len(args) >= 3:
        return (f"conv_stats_bf16_kernel<BN={args[0]}, CTAs/SM={args[1]}, "
                f"resident W={args[2]} B>")
    if re.fullmatch(r"wide_[fb]wd_(?:f32|bf16)_kernel", base) and args:
        return f"{base}<sparse={args[0]}>"
    if base == "wide_role_f32_kernel" and len(args) >= 2 \
            and args[0].isdigit():
        role = ("fwd", "dq", "dk", "dv")[int(args[0])]
        return f"wide_role_f32_kernel<{role}, sparse={args[1]}>"
    return f"{base}<{', '.join(args)}>" if args else base
