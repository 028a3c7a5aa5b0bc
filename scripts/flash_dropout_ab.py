"""Flash-attention kernel times of two source trees, with and without
dropout, in one session on one card: rows 1–6 of PERF.md §6 at the main
path's shapes (``chip_smoke.phase_kernel``, ``phase_kernel_bwd`` and
``phase_kernel_sparse``: each checks the kernels against their plain
versions and times both).

    python3 scripts/flash_dropout_ab.py PARENT_ROOT [CHANGE_ROOT] [--out F]

PARENT_ROOT and CHANGE_ROOT (default: this checkout) are roots of the
repo, for example a ``git archive`` of the parent commit unpacked into a
git-ignored folder. Each tree runs in a process of its own, in the order
parent, change, change, parent, and builds its kernels into its own
``paddle_tpu_torch/_build/``. Prints the card's name and power limit
(``nvidia-smi``), one JSON line a run, then one object: each entry's
median ms (and +drop ms) a tree and change/parent.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_RUN = r"""
import json, sys
tree = sys.argv[1]
sys.path.insert(0, tree)
import chip_smoke as cs
from paddle_tpu_torch.core.executor import cuda_device
from paddle_tpu_torch.ops.kernels import build
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import flash_attention_sparse as fas
assert fa.__file__.startswith(tree), fa.__file__
cuda_device(0)
build.build_all(["flash_attention_fwd", "flash_attention_bwd",
                 "flash_attention_sparse"])
out = {}
for kind, recs in (("fwd", cs.phase_kernel(fa)),
                   ("bwd", cs.phase_kernel_bwd(fa)),
                   ("sparse", cs.phase_kernel_sparse(fas))):
    for key, rec in recs.items():
        out[f"{kind} {key}"] = {k: rec[k] for k in ("ms", "dropout_ms")
                                if k in rec}
print("AB " + json.dumps(out), flush=True)
"""


def _run(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _RUN, tree], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: rc {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")][-1]
    return json.loads(line[3:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    runs = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent"):
        got = _run(trees[tag])
        runs[tag].append(got)
        print(json.dumps({"tree": tag, "times": got}), flush=True)
    summary = {}
    for key in runs["parent"][0]:
        row = {}
        for field in ("ms", "dropout_ms"):
            if field not in runs["parent"][0][key]:
                continue
            med = {tag: statistics.median(r[key][field] for r in runs[tag])
                   for tag in runs}
            row[field] = {**med, "change/parent": med["change"]
                          / med["parent"]}
        summary[key] = row
    print(json.dumps({"card": smi, "summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": runs, "summary": summary}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
