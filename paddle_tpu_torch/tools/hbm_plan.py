"""Device-memory budget planner CLI (the port's copy of
``paddle_tpu.tools.hbm_plan``).

Answers "will this model fit, and under which (sharding stage, remat
policy, microbatch) config?" for a named bench model: each candidate on
the planner ladder is bounded analytically and, where the bound fits,
measured over one step in a throwaway scope (``planner._measured_bytes``).
Prints the candidate table and the chosen plan as one JSON line; exits 2
with the best-found plan when nothing fits.

CLI::

    python -m paddle_tpu_torch.tools.hbm_plan --model nmt --batch 8 --seq 64
    python -m paddle_tpu_torch.tools.hbm_plan --model bert --budget 4e9
    python -m paddle_tpu_torch.tools.hbm_plan --model mlp --budget 16384 --json

``--budget`` accepts bytes (float ok: 4e9); without it 0.9 of the card's
memory decides (``--device cpu``: unconstrained unless a budget is given —
the baseline plan wins unevaluated). The steps run on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .. import planner


def _build_model(name: str, batch: int, seq: int):
    """(program, feed, loss_name) for a named bench model at the given
    shape — build only, nothing is initialized or run."""
    import paddle_tpu_torch as fluid

    if name == "bert":
        from ..models import bert
        cfg = bert.BertConfig(num_layers=2, hidden_size=128, num_heads=4,
                              ffn_size=256, vocab_size=1000)
        program, _startup, _feeds, loss = bert.build_pretrain_program(
            cfg, batch, seq)
        rng = np.random.RandomState(0)
        feed = {
            "src_ids": rng.randint(0, 1000, (batch, seq)).astype("int32"),
            "pos_ids": np.tile(np.arange(seq), (batch, 1)).astype("int32"),
            "sent_ids": np.zeros((batch, seq), dtype="int32"),
            "input_mask": np.ones((batch, seq), dtype="float32"),
            "mlm_labels": rng.randint(0, 1000,
                                      (batch, seq, 1)).astype("int32"),
        }
        return program, feed, loss.name
    if name == "nmt":
        from ..models import transformer_nmt as nmt
        cfg = nmt.TransformerConfig(d_model=64, n_heads=4, d_ff=128,
                                    n_enc=2, n_dec=2, src_vocab=1000,
                                    tgt_vocab=1000)
        program, _startup, _feeds, loss = nmt.build_train_program(
            cfg, seq, seq)
        rng = np.random.RandomState(0)
        causal = np.triu(np.full((seq, seq), -1e4, "float32"), 1)
        feed = {
            "src_ids": rng.randint(1, 1000, (batch, seq)).astype("int32"),
            "tgt_ids": rng.randint(1, 1000, (batch, seq)).astype("int32"),
            "lbl_ids": rng.randint(1, 1000, (batch, seq, 1)).astype("int32"),
            "src_mask": np.zeros((batch, 1, 1, seq), "float32"),
            "tgt_mask": np.broadcast_to(causal, (batch, 1, seq, seq)).copy(),
        }
        return program, feed, loss.name
    if name == "mlp":
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [64], dtype="float32")
            y = fluid.layers.data("y", [1], dtype="float32")
            h = fluid.layers.fc(x, 256, act="relu")
            h = fluid.layers.fc(h, 256, act="relu")
            out = fluid.layers.fc(h, 1)
            loss = fluid.layers.mean(fluid.layers.square(out - y))
            fluid.optimizer.Adam(1e-3).minimize(loss)
        rng = np.random.RandomState(0)
        feed = {"x": rng.rand(batch, 64).astype("float32"),
                "y": rng.rand(batch, 1).astype("float32")}
        return main, feed, loss.name
    raise SystemExit(f"unknown --model {name!r} (bert | nmt | mlp)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hbm_plan",
        description="pre-compile HBM budget planning for a bench model")
    ap.add_argument("--model", default="mlp", help="bert | nmt | mlp")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--budget", type=float, default=None,
                    help="HBM budget in bytes/device (default: device "
                         "bytes_limit, unconstrained on CPU)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output only")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the measured steps run (default: the card)")
    args = ap.parse_args(argv)

    import paddle_tpu_torch as fluid

    place = fluid.CUDAPlace(0) if args.device == "cuda" else fluid.CPUPlace()
    program, feed, loss_name = _build_model(args.model, args.batch, args.seq)
    budget = int(args.budget) if args.budget is not None else None
    if budget is None:
        budget = planner.resolve_budget_bytes(place)

    try:
        plan = planner.plan_for(program, feed, loss_name,
                                budget_bytes=budget,
                                where=f"hbm_plan/{args.model}", place=place)
        chosen, candidates, code = plan, planner._last_candidates, 0
    except planner.HbmBudgetError as e:
        chosen, candidates, code = e.plan, e.candidates, 2

    out = {"model": args.model, "batch": args.batch, "seq": args.seq,
           "device": args.device, "budget_bytes": budget,
           "fits": code == 0,
           "chosen": chosen.to_dict() if chosen else None,
           "candidates": [p.to_dict() for p in candidates]}
    if args.json:
        print(json.dumps(out))
        return code
    for p in candidates:
        mark = "*" if (chosen is not None
                       and (p.stage, p.remat, p.microbatch)
                       == (chosen.stage, chosen.remat, chosen.microbatch)) \
            else " "
        fit = {True: "fits", False: "over", None: "?"}[p.fits]
        print(f" {mark} {p.describe():<60} {fit}")
    if code == 0:
        print(f"chosen: {chosen.describe()}")
    else:
        print(f"NO FIT under {budget} bytes/device — best: "
              f"{chosen.describe() if chosen else 'none'}")
    print(json.dumps(out))
    return code


if __name__ == "__main__":
    sys.exit(main())
