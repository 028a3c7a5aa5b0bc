"""int8 post-training quantization for the inference Predictor
(counterpart of ``paddle_tpu.inference.quant``).

Reference analog: the reference's slim/quantization post-training path
(PostTrainingQuantization: sample-driven activation calibration, weight
abs-max quant, program rewrite). One IR pass over the frozen serving
program, in three steps:

1. **Calibrate** — run the fp32 program eagerly
   (`core.executor.eval_inference_block`) over a small sample stream and
   record the abs-max of every activation entering a quantizable matmul
   (per tensor, symmetric): one host read per watched tensor per feed.
2. **Rewrite** — `int8_quantize_pass` replaces `fused_fc`/`mul`/`matmul`
   (persistable f32 weight) with `quantized_fc` (int8 weight, per
   out-channel scale var, calibrated activation scale attr) and
   `lookup_table(_v2)` (persistable table) with `quantized_lookup_table`
   (int8 rows, per-table scale), u16 row-packed CTR tables included, whose
   visible f32 columns are unpacked bit-exactly and requantized. The
   weights are quantized in numpy, as in the JAX package, so the int8
   weights and scales are bitwise the JAX package's. Weights leave the
   predictor state; int8 twins enter it, on the predictor's device.
3. **Gate** — replay the calibration stream through the quantized
   predictor and compare against the fp32 outputs: the worst output's mean
   relative L1 delta must stay within the accuracy budget
   (``PDTPU_INT8_ACC_BUDGET``, default 0.05) or promotion fails with
   :class:`QuantizationError`.

The calibration record lands on ``program._quant_meta`` (surfaced as
``Predictor.quant_meta``): activation scales, per-table scales (the PS
delta-push requantization path reads these), the measured accuracy delta
and its budget (the fleet ModelRegistry's int8 promotion gate reads
those).
"""
from __future__ import annotations

import os

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.dtypes import dtype_str, from_numpy, to_numpy
from ..core.program import Operator, Program
from ..ir.pass_base import Pass, register_pass

__all__ = ["QuantizationError", "Int8QuantizePass", "calibrate_activations",
           "quantize_predictor_inplace", "requantize_packed_rows"]

DEFAULT_ACCURACY_BUDGET = 0.05

# fc-family ops whose (activation, persistable-weight) matmul quantizes
_FC_SLOTS = {
    "fused_fc": ("Input", "W"),
    "mul": ("X", "Y"),
    "matmul": ("X", "Y"),
    "matmul_v2": ("X", "Y"),
}


class QuantizationError(ValueError):
    """Quantization could not be applied or failed its accuracy gate."""


def default_budget() -> float:
    return float(os.environ.get("PDTPU_INT8_ACC_BUDGET",
                                str(DEFAULT_ACCURACY_BUDGET)))


def _dt(t) -> str:
    return dtype_str(t.dtype)


def _fc_candidates(program: Program, state: Dict):
    """(op, x_name, w_name) for every fc-family op whose weight is a
    resident f32 2-D state tensor (activation×activation matmuls, e.g.
    attention scores, stay float)."""
    out = []
    for op in program.global_block().ops:
        slots = _FC_SLOTS.get(op.type)
        if slots is None:
            continue
        if op.type.startswith("matmul") and (
                op.attr("transpose_X", False) or op.attr("transpose_Y", False)
                or op.attr("alpha", 1.0) not in (1, 1.0)):
            continue
        xs, ws = op.input(slots[0]), op.input(slots[1])
        if not xs or not ws:
            continue
        w = state.get(ws[0])
        if w is None or w.ndim != 2 or _dt(w) != "float32":
            continue
        if op.type == "mul" and op.attr("y_num_col_dims", 1) != 1:
            continue
        out.append((op, xs[0], ws[0]))
    return out


def _table_candidates(program: Program, state: Dict):
    """(op, w_name, row_pack_dt) for quantizable embedding lookups."""
    out = []
    for op in program.global_block().ops:
        if op.type not in ("lookup_table", "lookup_table_v2"):
            continue
        if "PendingPos" in op.inputs:  # deferred-update training wiring
            continue
        ws = op.input("W")
        w = state.get(ws[0]) if ws else None
        if w is None or w.ndim != 2:
            continue
        rp_dt = op.attr("row_pack_dt", None) if op.type == "lookup_table" \
            else None
        if rp_dt:
            if _dt(w) != "uint16":
                continue
        elif _dt(w) != "float32":
            continue
        out.append((op, ws[0], int(rp_dt) if rp_dt else None))
    return out


def requantize_packed_rows(rows: np.ndarray, dt: int,
                           scale: float) -> np.ndarray:
    """u16 row-packed embedding rows (`[k, lanes]`, f32 bit-split into the
    first 2·dt lanes) → int8 `[k, dt]` at the table's stored scale. The
    delta-push refresh path: bytes the trainer streams are packed u16 and
    re-enter an int8 resident table through the quantizer the table was
    built with."""
    u = np.ascontiguousarray(np.asarray(rows, np.uint16)[:, :2 * int(dt)])
    f = u.view(np.float32)  # little-endian pairwise bitcast == unpack_rows
    inv = 127.0 / max(float(scale), 1e-8)
    return np.clip(np.round(f * inv), -127, 127).astype(np.int8)


def _quantize_weight_cols(w: np.ndarray):
    """f32 [k, n] → (int8 [k, n], f32 [n] per-out-channel abs-max)."""
    s = np.maximum(np.max(np.abs(w), axis=0), 1e-8).astype(np.float32)
    q = np.clip(np.round(w / s[None, :] * 127.0), -127, 127).astype(np.int8)
    return q, s


@register_pass
class Int8QuantizePass(Pass):
    """Rewrite matmul/embedding paths to int8 (module docstring).

    Needs ``state=`` (the predictor's name→tensor map, edited in place:
    int8 twins in, dead f32 weights out) and ``act_scales=`` (calibrated
    per-tensor activation abs-max, from :func:`calibrate_activations`).
    An fc whose activation was never observed stays float."""

    name = "int8_quantize_pass"
    neutrality = "precision"

    def apply_impl(self, program: Program, state: Optional[Dict] = None,
                   act_scales: Optional[Dict[str, float]] = None,
                   table_scales: Optional[Dict[str, float]] = None, **kw):
        if state is None:
            return program
        act_scales = act_scales or {}
        table_scales = table_scales or {}
        blk = program.global_block()
        meta = {"tables": {}, "fc": {}}
        quantized_w: Dict[str, tuple] = {}
        changed = False

        for op, x_name, w_name in _fc_candidates(program, state):
            sx = act_scales.get(x_name)
            if not sx or sx <= 0.0:
                continue
            if w_name in quantized_w:
                w8_name, ws_name = quantized_w[w_name]
            else:
                dev = state[w_name].device
                q, s = _quantize_weight_cols(to_numpy(state[w_name]))
                w8_name, ws_name = f"{w_name}@int8", f"{w_name}@wscale"
                blk.create_var(name=w8_name, shape=list(q.shape),
                               dtype="int8", persistable=True)
                blk.create_var(name=ws_name, shape=[int(s.shape[0])],
                               dtype="float32", persistable=True)
                state[w8_name] = from_numpy(q, device=dev)
                state[ws_name] = from_numpy(s, device=dev)
                quantized_w[w_name] = (w8_name, ws_name)
            if op.type == "fused_fc":
                ncol = op.attr("in_num_col_dims", 1)
                act = op.attr("activation_type", "")
                bias = op.input("Bias")
            elif op.type == "mul":
                ncol, act, bias = op.attr("x_num_col_dims", 1), "", None
            else:  # matmul: leading dims all batch
                ncol, act, bias = -1, "", None
            inputs = {"Input": [x_name], "W": [w8_name],
                      "WScale": [ws_name]}
            if bias:
                inputs["Bias"] = bias
            idx = blk.ops.index(op)
            blk.ops[idx] = Operator(
                blk, "quantized_fc", inputs, {"Out": op.output("Out")},
                {"in_num_col_dims": ncol, "activation_type": act,
                 "act_scale": float(sx)})
            meta["fc"][op.output("Out")[0]] = {
                "weight": w_name, "act_scale": float(sx)}
            changed = True

        for op, w_name, rp_dt in _table_candidates(program, state):
            if w_name in meta["tables"]:
                rec = meta["tables"][w_name]
                w8_name = rec["param"]
            else:
                dev = state[w_name].device
                w = to_numpy(state[w_name])
                if rp_dt:
                    lanes = int(w.shape[1])
                    f = np.ascontiguousarray(
                        w[:, :2 * rp_dt]).view(np.float32)
                else:
                    lanes = None
                    f = w
                if w_name in table_scales:
                    # PS-cache-sized serving tables hold a placeholder
                    # slice of the real table: the deployment pins the full
                    # table's abs-max instead
                    scale = float(table_scales[w_name])
                else:
                    scale = max(float(np.max(np.abs(f))) if f.size else 0.0,
                                1e-8)
                q = np.clip(np.round(f * (127.0 / scale)),
                            -127, 127).astype(np.int8)
                w8_name = f"{w_name}@int8_rows"
                blk.create_var(name=w8_name, shape=list(q.shape),
                               dtype="int8", persistable=True)
                state[w8_name] = from_numpy(q, device=dev)
                rec = {"param": w8_name, "scale": scale,
                       "dt": int(f.shape[1]), "packed": bool(rp_dt),
                       "lanes": lanes}
                meta["tables"][w_name] = rec
            idx = blk.ops.index(op)
            blk.ops[idx] = Operator(
                blk, "quantized_lookup_table",
                {"W": [w8_name], "Ids": op.input("Ids")},
                {"Out": op.output("Out")},
                {"table_scale": rec["scale"],
                 "padding_idx": op.attr("padding_idx", -1),
                 "squeeze_last": op.type == "lookup_table"})
            changed = True

        if changed:
            # f32 weights nothing reads any more leave the device
            read = {n for op2 in blk.ops for n in op2.input_names()}
            for w_name in list(quantized_w) + list(meta["tables"]):
                if w_name not in read:
                    state.pop(w_name, None)
            program._quant_partial = meta  # full meta lands after gating
            program._bump_version()
        return program


def _feed_env(pred, feed: Dict[str, np.ndarray]) -> Dict:
    from ..core.executor import convert_feed_value

    blk = pred._program.global_block()
    env = dict(pred._state)
    for n in pred._feed_names:
        if n not in feed:
            raise ValueError(f"calibration feed missing input {n!r}")
        env[n] = convert_feed_value(blk, n, feed[n], pred._device)
    return env


def calibrate_activations(pred, sample_feeds: Sequence[Dict[str, np.ndarray]]
                          ) -> Dict[str, float]:
    """Per-tensor abs-max of every activation entering a quantizable fc,
    observed by running the fp32 program eagerly over the samples."""
    from ..core.executor import eval_inference_block

    watch = {x for _, x, _ in _fc_candidates(pred._program, pred._state)}
    scales: Dict[str, float] = {}
    with torch.inference_mode():
        for feed in sample_feeds:
            env = eval_inference_block(pred._program, _feed_env(pred, feed))
            for name in sorted(watch):
                if name in env:
                    cur = float(torch.max(torch.abs(env[name])))
                    scales[name] = max(scales.get(name, 0.0), cur)
    return scales


def _accuracy_delta(ref_outs: List[List[np.ndarray]],
                    q_outs: List[List[np.ndarray]]) -> float:
    """Worst-output mean relative L1 between fp32 and int8 runs."""
    per_output: List[List[float]] = []
    for ref, q in zip(ref_outs, q_outs):
        for i, (f, g) in enumerate(zip(ref, q)):
            f = np.asarray(f, np.float32)
            g = np.asarray(g, np.float32)
            den = float(np.mean(np.abs(f))) + 1e-8
            rel = float(np.mean(np.abs(g - f))) / den
            while len(per_output) <= i:
                per_output.append([])
            per_output[i].append(rel)
    return max((float(np.mean(v)) for v in per_output), default=0.0)


def quantize_predictor_inplace(pred, sample_feeds, accuracy_budget=None,
                               table_scales=None):
    """Calibrate → rewrite → gate, on a freshly loaded fp32 predictor (the
    `Predictor(precision="int8")` path). Raises :class:`QuantizationError`
    when there is nothing to quantize or the measured accuracy delta
    exceeds the budget. ``table_scales`` pins per-table quantization
    scales (PS-backed serving, where the resident cache-sized table is not
    the real data)."""
    from ..ir import PassPipeline

    if not sample_feeds:
        raise QuantizationError(
            "int8 serving needs a calibration stream — call "
            "Config.enable_int8(sample_feeds=[...]) with representative "
            "feeds before create_predictor")
    sample_feeds = list(sample_feeds)
    budget = float(accuracy_budget) if accuracy_budget is not None \
        else default_budget()

    ref_outs = [pred.run(f) for f in sample_feeds]
    scales = calibrate_activations(pred, sample_feeds)

    pipeline = PassPipeline(
        ["int8_quantize_pass", "dead_var_elimination_pass"],
        label=getattr(pred, "_label", None))
    pred._program = pipeline.run(
        pred._program, state=pred._state, act_scales=scales,
        table_scales=table_scales,
        keep=pred._fetch_names, fetch_names=pred._fetch_names)
    meta = getattr(pred._program, "_quant_partial", None)
    if meta is None or not (meta["fc"] or meta["tables"]):
        raise QuantizationError(
            "int8_quantize_pass found nothing to quantize — the program "
            "has no matmul/embedding op with a resident f32 weight")
    pred._cache.clear()

    q_outs = [pred.run(f) for f in sample_feeds]
    delta = _accuracy_delta(ref_outs, q_outs)
    if delta > budget:
        raise QuantizationError(
            f"int8 accuracy gate failed: measured delta {delta:.4f} "
            f"exceeds budget {budget:.4f} over {len(sample_feeds)} "
            f"calibration samples — raise the budget explicitly "
            f"(Config.enable_int8(accuracy_budget=...)) only if the "
            f"serving SLO tolerates it")
    pred._program._quant_meta = {
        "precision": "int8",
        "accuracy_delta": round(delta, 6),
        "accuracy_budget": budget,
        "samples": len(sample_feeds),
        "act_scales": {k: float(v) for k, v in scales.items()},
        "tables": meta["tables"],
        "fc": meta["fc"],
    }
    del pred._program._quant_partial
    return pred
