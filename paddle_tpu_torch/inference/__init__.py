"""Inference engine: analysis config + predictor (counterpart of
``paddle_tpu.inference``; reference ``paddle/fluid/inference/`` —
AnalysisConfig, AnalysisPredictor Run:216 / clone, the analysis pass
pipeline).

Loading runs the same IR pass pipeline as the JAX package (delete-dropout →
fc/add-act fusion → constant folding → DCE → liveness), then serves the
pruned program eagerly under ``torch.inference_mode()`` on the GPU unless the
config asks for the CPU. A model directory in the reference framework's
protobuf format loads through ``compat`` and serves the same way. Weight
sharing across clones = sharing the same device tensors. Capturing the serve call as a CUDA graph and int8 serving
are not ported yet.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.executor import (CPUPlace, ExecContext, _run_block,
                             convert_feed_value, cuda_device)
from ..core.scope import Scope, scope_guard
from ..ir import PassBuilder

__all__ = ["Config", "Predictor", "create_predictor", "PrecisionType"]


class PrecisionType:
    Float32 = "float32"
    Bfloat16 = "bfloat16"
    # API-compat alias: the low-precision serving dtype is bf16
    Half = "bfloat16"
    Int8 = "int8"


_PRECISION_ALIASES = {
    "f32": PrecisionType.Float32, "fp32": PrecisionType.Float32,
    "float32": PrecisionType.Float32,
    "bf16": PrecisionType.Bfloat16, "bfloat16": PrecisionType.Bfloat16,
    "half": PrecisionType.Bfloat16, "fp16": PrecisionType.Bfloat16,
    "float16": PrecisionType.Bfloat16,
    "int8": PrecisionType.Int8, "i8": PrecisionType.Int8,
}


def _resolve_precision(precision) -> str:
    try:
        p = _PRECISION_ALIASES[str(precision).lower()]
    except KeyError:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of "
            f"{sorted(set(_PRECISION_ALIASES))}") from None
    if p == PrecisionType.Int8:
        raise NotImplementedError(
            "int8 serving is not ported to paddle_tpu_torch yet")
    return p


class Config:
    """AnalysisConfig parity (paddle_analysis_config.h). Serves on CUDA
    device 0 unless `disable_gpu()` is called."""

    Precision = PrecisionType

    def __init__(self, model_dir: Optional[str] = None,
                 model_filename: Optional[str] = None,
                 params_filename: Optional[str] = None):
        self._model_dir = model_dir
        self._model_filename = model_filename
        self._params_filename = params_filename
        self._ir_optim = True
        self._memory_optim = True
        self._precision = PrecisionType.Float32
        self._use_gpu = True
        self._gpu_device_id = 0
        self._passes_deleted: List[str] = []
        self._extra_passes: List[str] = []

    # -- model location ----------------------------------------------------
    def set_model(self, model_dir: str, params_file: Optional[str] = None):
        self._model_dir = model_dir
        if params_file:
            self._params_filename = params_file

    def model_dir(self) -> Optional[str]:
        return self._model_dir

    # -- switches (reference switch_* API) ---------------------------------
    def switch_ir_optim(self, flag: bool = True):
        self._ir_optim = flag

    def ir_optim(self) -> bool:
        return self._ir_optim

    def enable_memory_optim(self, flag: bool = True):
        self._memory_optim = flag

    def enable_int8(self, *a, **kw):
        raise NotImplementedError(
            "int8 serving (post-training quantization) is not ported to "
            "paddle_tpu_torch yet")

    def enable_use_gpu(self, memory_pool_init_size_mb: int = 0,
                       device_id: int = 0):
        """Serve on CUDA device `device_id` (the default). The memory-pool
        size is the caching allocator's business and is ignored."""
        self._use_gpu = True
        self._gpu_device_id = int(device_id)

    def disable_gpu(self):
        """Serve on the CPU."""
        self._use_gpu = False

    def device(self) -> torch.device:
        """The device this config serves on; a RuntimeError when it asks for
        a GPU and torch sees none."""
        if not self._use_gpu:
            return torch.device("cpu")
        return cuda_device(self._gpu_device_id,
                           hint="call Config.disable_gpu() to serve on the CPU")

    def delete_pass(self, name: str):
        self._passes_deleted.append(name)

    def append_pass(self, name: str):
        self._extra_passes.append(name)

    def pass_builder(self) -> PassBuilder:
        names = ["delete_dropout_op_pass", "conv_bn_fuse_pass",
                 "fc_fuse_pass",
                 "fuse_elewise_add_act_pass", "constant_folding_pass",
                 "dead_code_elimination_pass", "dead_var_elimination_pass",
                 "layout_assignment_pass"]
        if self._memory_optim:
            names.append("memory_optimize_pass")
        names += self._extra_passes
        return PassBuilder([n for n in names if n not in self._passes_deleted])


class Predictor:
    """AnalysisPredictor parity: load → optimize → run eagerly on the
    config's device."""

    def __init__(self, config: Config, precision: Optional[str] = None,
                 _shared=None):
        self._config = config
        # `precision` overrides the Config's dtype per predictor, so one
        # model dir can serve f32 and bf16 replicas
        self._precision = _resolve_precision(
            precision if precision is not None else config._precision)
        self._device = config.device()
        if _shared is not None:
            # clone path (analysis_predictor.cc:479): share program + weights
            (self._program, self._feed_names, self._fetch_names,
             self._state, self._label) = _shared
            return
        self._load_and_optimize()

    def _load_and_optimize(self):
        from .. import io

        cfg = self._config
        if cfg.model_dir() is None:
            raise ValueError("Config.set_model(dir) required")
        scope = Scope()
        model_path = os.path.join(cfg.model_dir(),
                                  cfg._model_filename or "__model__")
        with scope_guard(scope):
            # parameters land on the host, then move once, cast as served
            if io._is_reference_model_file(model_path):
                # a model dir in the REFERENCE framework's format (binary
                # protobuf ProgramDesc + LoDTensor var streams) serves
                # directly, as the JAX package's Predictor serves it
                from ..compat import load_reference_inference_model
                program, feed_names, fetch_names = \
                    load_reference_inference_model(
                        cfg.model_dir(), model_filename=cfg._model_filename,
                        params_filename=cfg._params_filename, scope=scope,
                        place=CPUPlace())
            else:
                program, feed_names, fetch_vars = io.load_inference_model(
                    cfg.model_dir(), None,
                    model_filename=cfg._model_filename,
                    params_filename=cfg._params_filename)
                fetch_names = [v.name for v in fetch_vars]
        base = os.path.basename(os.path.normpath(cfg.model_dir() or "")) \
            or "model"
        self._label = f"infer:{base}:{self._precision}"
        if cfg.ir_optim():
            from ..ir import PassPipeline
            pipeline = PassPipeline(cfg.pass_builder(), label=self._label)
            with scope_guard(scope):  # weight-folding passes edit the scope
                program = pipeline.run(program, keep=fetch_names,
                                       fetch_names=fetch_names, scope=scope)
        self._program = program
        self._feed_names = list(feed_names)
        self._fetch_names = fetch_names
        self._state = {}
        for v in program.list_vars():
            if v.persistable and scope.has_var(v.name):
                self._state[v.name] = self._serve_cast(
                    scope.find_var(v.name).to(self._device))

    def _serve_cast(self, t: torch.Tensor) -> torch.Tensor:
        if self._precision == PrecisionType.Bfloat16 and t.dtype == torch.float32:
            return t.to(torch.bfloat16)
        return t

    # -- reference API surface ---------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def clone(self) -> "Predictor":
        """New predictor sharing program + device weights (zero-copy; the
        reference's clone-weights optimization)."""
        return Predictor(self._config, precision=self._precision,
                         _shared=(self._program, self._feed_names,
                                  self._fetch_names, self._state,
                                  self._label))

    @property
    def pass_report(self) -> Optional[dict]:
        """The IR pass pipeline's per-pass cost-delta report (None when
        ir_optim was off)."""
        return getattr(self._program, "_pass_report", None)

    def run(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """Run once on `feed`. A bf16 predictor returns its bf16 outputs
        widened (exactly) to float32 numpy arrays, since numpy has no
        bfloat16 of its own."""
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise ValueError(f"missing feeds: {missing}")
        blk = self._program.global_block()
        env = dict(self._state)
        for n in self._feed_names:
            env[n] = self._serve_cast(
                convert_feed_value(blk, n, feed[n], self._device))
        with torch.inference_mode():
            _run_block(blk, env, ExecContext(self._device, is_test=True))
            return [_host(env[n]) for n in self._fetch_names]

    def run_padded(self, feed: Dict[str, np.ndarray], batch_size: int) -> List[np.ndarray]:
        """Run with every feed padded along axis 0 to `batch_size` rows and
        batch-major outputs sliced back to the true row count.

        Padding ragged traffic to a small set of bucket sizes keeps the
        shapes the server sees bounded. Pads by replicating the last row
        ("edge") so integer id feeds stay in-vocab; the pad rows' outputs
        are computed and discarded. Every feed must share the same leading
        (batch) dimension.
        """
        if not feed:
            raise ValueError("run_padded: empty feed")
        ns = {k: (np.asarray(v).shape[0] if np.asarray(v).ndim else -1)
              for k, v in feed.items()}
        n = next(iter(ns.values()))
        if n <= 0 or any(m != n for m in ns.values()):
            raise ValueError(
                f"run_padded: feeds must share one positive leading batch "
                f"dim; got {ns}")
        if n > batch_size:
            raise ValueError(
                f"run_padded: {n} rows exceed the bucket size {batch_size}")
        padded = {}
        for k, v in feed.items():
            v = np.asarray(v)
            if n < batch_size:
                width = [(0, batch_size - n)] + [(0, 0)] * (v.ndim - 1)
                v = np.pad(v, width, mode="edge")
            padded[k] = v
        outs = self.run(padded)
        # non-batch-major outputs (no leading batch dim) pass through whole
        return [o[:n] if (o.ndim and o.shape[0] == batch_size) else o
                for o in outs]


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def create_predictor(config: Config,
                     precision: Optional[str] = None) -> Predictor:
    return Predictor(config, precision=precision)
