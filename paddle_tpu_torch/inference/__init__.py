"""Inference engine: analysis config + predictor (counterpart of
``paddle_tpu.inference``; reference ``paddle/fluid/inference/`` —
AnalysisConfig, AnalysisPredictor Run:216 / clone, the analysis pass
pipeline).

Loading runs the same IR pass pipeline as the JAX package (delete-dropout →
fc/add-act fusion → constant folding → DCE → liveness), then serves the
pruned program eagerly under ``torch.inference_mode()`` on the GPU unless the
config asks for the CPU, in f32, bf16 or int8 (post-training quantized:
``Config.enable_int8`` → calibrate → rewrite → gate, ``quant.py``). A model
directory in the reference framework's protobuf format loads through
``compat`` and serves the same way. Weight sharing across clones = sharing
the same device tensors. The predictor keeps a record of the feed
signatures it has served (``_cache``), the counterpart of the JAX package's
per-signature executable cache, which serving warmup reads. Capturing the
serve call as a CUDA graph is not ported yet.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.executor import (CPUPlace, ExecContext, _run_block,
                             _sig_digest, convert_feed_value, cuda_device,
                             feed_signature)
from ..core.scope import Scope, scope_guard
from ..ir import PassBuilder
from ..observability import perf

__all__ = ["Config", "Predictor", "Tensor", "create_predictor",
           "PrecisionType", "AnalysisConfig", "create_paddle_predictor",
           "PsLookupBinding", "PsLookupPredictor", "RowCache",
           "QuantizationError"]


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
        return _PRECISION_ALIASES[str(precision).lower()]
    except KeyError:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of "
            f"{sorted(set(_PRECISION_ALIASES))}") from None


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
        self._int8_calib_feeds: Optional[List[dict]] = None
        self._int8_budget: Optional[float] = None
        self._int8_table_scales: Optional[Dict[str, float]] = None

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

    def enable_tpu(self, precision: str = PrecisionType.Float32):
        """The JAX package's precision setter (the name is its own): sets
        the serving precision; the device stays this config's."""
        self._precision = _resolve_precision(precision)

    def enable_int8(self, sample_feeds: Sequence[Dict[str, np.ndarray]],
                    accuracy_budget: Optional[float] = None,
                    table_scales: Optional[Dict[str, float]] = None):
        """Serve this model post-training-quantized to int8.

        ``sample_feeds`` is the calibration stream, a handful of
        representative feed dicts: the predictor runs them at fp32 to
        observe activation abs-max ranges, quantizes the matmul and
        embedding paths, and gates promotion on the measured fp32-vs-int8
        output delta staying within ``accuracy_budget`` (relative L1;
        default ``PDTPU_INT8_ACC_BUDGET``, 0.05). ``table_scales`` pins
        embedding-table quantization scales by param name, which PS-backed
        serving needs (the resident cache-sized table is a placeholder for
        the real ShardedTable)."""
        sample_feeds = list(sample_feeds or [])
        if not sample_feeds:
            raise ValueError(
                "enable_int8: calibration needs at least one sample feed")
        self._precision = PrecisionType.Int8
        self._int8_calib_feeds = sample_feeds
        if accuracy_budget is not None:
            self._int8_budget = float(accuracy_budget)
        if table_scales is not None:
            self._int8_table_scales = {k: float(v)
                                       for k, v in table_scales.items()}

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


AnalysisConfig = Config  # old-API alias (paddle_analysis_config.h)


class Tensor:
    """Serve-side tensor handle (reference PaddleTensor / ZeroCopyTensor:
    copy_from_cpu / copy_to_cpu)."""

    def __init__(self, name: str, predictor: "Predictor"):
        self.name = name
        self._predictor = predictor

    def copy_from_cpu(self, arr: np.ndarray):
        self._predictor._feed_buf[self.name] = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        return np.asarray(self._predictor._fetch_buf[self.name])

    def reshape(self, shape: Sequence[int]):
        buf = self._predictor._feed_buf.get(self.name)
        if buf is not None:
            self._predictor._feed_buf[self.name] = buf.reshape(shape)

    def shape(self):
        buf = (self._predictor._feed_buf.get(self.name)
               if self.name in self._predictor._feed_buf
               else self._predictor._fetch_buf.get(self.name))
        return list(buf.shape) if buf is not None else None


class Predictor:
    """AnalysisPredictor parity: load → optimize → run eagerly on the
    config's device."""

    def __init__(self, config: Config, precision: Optional[str] = None,
                 _shared=None):
        self._config = config
        # feed signatures served so far (warmup reads its size)
        self._cache: set = set()
        self._feed_buf: Dict[str, np.ndarray] = {}
        self._fetch_buf: Dict[str, np.ndarray] = {}
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
        if self._precision == PrecisionType.Int8:
            from .quant import quantize_predictor_inplace
            quantize_predictor_inplace(
                self, sample_feeds=cfg._int8_calib_feeds,
                accuracy_budget=cfg._int8_budget,
                table_scales=cfg._int8_table_scales)

    def _serve_cast(self, t: torch.Tensor) -> torch.Tensor:
        if self._precision == PrecisionType.Bfloat16 and t.dtype == torch.float32:
            return t.to(torch.bfloat16)
        return t

    # -- reference API surface ---------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def get_input_handle(self, name: str) -> Tensor:
        return Tensor(name, self)

    def get_output_handle(self, name: str) -> Tensor:
        return Tensor(name, self)

    # old-API spellings
    get_input_tensor = get_input_handle
    get_output_tensor = get_output_handle

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

    @property
    def quant_meta(self) -> Optional[dict]:
        """int8 calibration record: activation scales, per-table scales,
        measured accuracy delta and its budget (None unless quantized).
        The fleet's ModelRegistry gate and the PS delta requantization path
        both read this."""
        return getattr(self._program, "_quant_meta", None)

    def run(self, feed: Optional[Dict[str, np.ndarray]] = None
            ) -> List[np.ndarray]:
        """Run once. Either pass `feed`, or fill the input handles with
        copy_from_cpu and call run() (zero-copy-run style). A bf16
        predictor returns its bf16 outputs widened (exactly) to float32
        numpy arrays, since numpy has no bfloat16 of its own. Safe to call
        from any thread: inference mode and the device are set here."""
        feed = dict(feed) if feed is not None else dict(self._feed_buf)
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise ValueError(f"missing feeds: {missing}")
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        blk = self._program.global_block()
        env = dict(self._state)
        feed_vals = {n: self._serve_cast(
            convert_feed_value(blk, n, feed[n], self._device))
            for n in self._feed_names}
        fsig = feed_signature(feed_vals)
        warm = fsig in self._cache
        self._cache.add(fsig)
        env.update(feed_vals)
        sig = _sig_digest(fsig)
        t0 = time.perf_counter()
        with torch.inference_mode():
            # serving-side perf attribution: a signature's first run is
            # counted once into one ledger entry per (program, signature)
            with perf.count_first_run(not warm) as counted:
                _run_block(blk, env, ExecContext(self._device, is_test=True))
            outs = [_host(env[n]) for n in self._fetch_names]
        if warm:   # the host read of the outputs waited for the card
            perf.get_ledger().on_dispatch(
                id(self._program), sig, (time.perf_counter() - t0) * 1e3)
        else:
            perf.get_ledger().register(
                id(self._program), sig, counted=counted and counted.cost(),
                program=self._program, feed=feed_vals,
                label=getattr(self, "_label", None))
        self._fetch_buf = dict(zip(self._fetch_names, outs))
        return outs

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
        outs = [o[:n] if (o.ndim and o.shape[0] == batch_size) else o
                for o in outs]
        self._fetch_buf = dict(zip(self._fetch_names, outs))
        return outs


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def create_predictor(config: Config,
                     precision: Optional[str] = None) -> Predictor:
    return Predictor(config, precision=precision)


def create_paddle_predictor(config: Config) -> Predictor:
    """Old-API alias (CreatePaddlePredictor)."""
    return Predictor(config)


from .ps_lookup import (PsLookupBinding, PsLookupPredictor,  # noqa: E402,F401
                        RowCache)
from .quant import QuantizationError  # noqa: E402,F401  (registers the pass)
