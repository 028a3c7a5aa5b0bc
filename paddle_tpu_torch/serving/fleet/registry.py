"""Versioned model registry: which model bytes may a replica serve?

Reference analog: the reference stack's serving deployments pushed
versioned model directories to replicas and flipped a `fluid_model`
symlink; here the registry is the explicit object — every version is a
validated inference-model directory plus metadata (serving precision,
the training checkpoint step it was exported from), and the fleet's
rollout/A-B machinery only ever speaks version names.

Checkpoint lineage: pass ``checkpointer=``/``step=`` at register time
and the registry reads the checkpoint's SHA-256 manifest via
``Checkpointer.verified_steps()`` — a version can only claim lineage
from a step whose on-disk bytes actually verify, so a torn or corrupt
training checkpoint can never be promoted to serving.

Quantization promotion gate: registering ``precision="int8"`` requires
``calibration={"accuracy_delta": ..., "samples": ...}`` metadata (the
measurement `inference.quant.quantize_predictor_inplace` produces), and
the recorded delta must sit inside the accuracy budget — an
uncalibrated or out-of-budget int8 export can never be promoted to a
servable version.
"""
from __future__ import annotations

import os
import threading

from collections import OrderedDict
from typing import List, Optional

__all__ = ["ModelRegistry", "ModelVersion"]


class ModelVersion:
    """One registered serving model: name → validated model dir."""

    __slots__ = ("version", "model_dir", "precision", "meta")

    def __init__(self, version: str, model_dir: str,
                 precision: Optional[str], meta: dict):
        self.version = version
        self.model_dir = model_dir
        self.precision = precision
        self.meta = meta

    def __repr__(self):
        return (f"ModelVersion({self.version!r}, {self.model_dir!r}, "
                f"precision={self.precision!r})")


class ModelRegistry:
    """Thread-safe version-name → ModelVersion map (insertion ordered:
    `latest()` is the most recently registered version)."""

    def __init__(self):
        self._versions: "OrderedDict[str, ModelVersion]" = OrderedDict()
        self._lock = threading.Lock()

    def register(self, version: str, model_dir: str,
                 precision: Optional[str] = None,
                 model_filename: Optional[str] = None,
                 checkpointer=None, step: Optional[int] = None,
                 **meta) -> ModelVersion:
        """Validate and record a version. The model dir must exist and
        contain the model file; with `checkpointer` the claimed training
        `step` (default: its newest verified step) must pass manifest
        verification and is recorded as ``meta["checkpoint_step"]``."""
        if not os.path.isdir(model_dir):
            raise ValueError(
                f"registry: model dir {model_dir!r} does not exist")
        model_path = os.path.join(model_dir, model_filename or "__model__")
        if not os.path.isfile(model_path):
            raise ValueError(
                f"registry: {model_path!r} missing — not an inference "
                f"model dir (io.save_inference_model writes __model__)")
        if precision is not None and str(precision).lower() in ("int8", "i8"):
            from ...inference.quant import default_budget
            calib = meta.get("calibration")
            if not isinstance(calib, dict) or "accuracy_delta" not in calib:
                raise ValueError(
                    f"registry: version {version!r} claims int8 but has no "
                    "calibration metadata — pass calibration={'accuracy_"
                    "delta': ..., 'samples': ...} (quantize_predictor_"
                    "inplace measures it); refusing to promote an "
                    "uncalibrated quantized model")
            budget = float(calib.get("accuracy_budget", default_budget()))
            delta = float(calib["accuracy_delta"])
            if delta > budget:
                raise ValueError(
                    f"registry: version {version!r} int8 accuracy delta "
                    f"{delta:.6f} exceeds budget {budget:.6f} — refusing "
                    "to promote; recalibrate with more samples or raise "
                    "the budget explicitly")
        if checkpointer is not None:
            verified = checkpointer.verified_steps()
            if step is None:
                if not verified:
                    raise ValueError(
                        "registry: checkpointer has no verified steps to "
                        "claim lineage from")
                step = verified[0]
            elif step not in verified:
                raise ValueError(
                    f"registry: checkpoint step {step} is not verified "
                    f"(verified steps: {verified}) — refusing to promote "
                    f"unverifiable training bytes to serving")
            meta = dict(meta, checkpoint_step=int(step))
        mv = ModelVersion(version, model_dir, precision, dict(meta))
        with self._lock:
            if version in self._versions:
                raise ValueError(
                    f"registry: version {version!r} already registered "
                    f"(at {self._versions[version].model_dir!r}); "
                    f"versions are immutable — pick a new name")
            self._versions[version] = mv
        return mv

    def resolve(self, version: str) -> ModelVersion:
        with self._lock:
            try:
                return self._versions[version]
            except KeyError:
                raise KeyError(
                    f"registry: unknown version {version!r}; registered: "
                    f"{list(self._versions)}") from None

    def versions(self) -> List[str]:
        with self._lock:
            return list(self._versions)

    def latest(self) -> Optional[str]:
        with self._lock:
            return next(reversed(self._versions), None)

    def __contains__(self, version: str) -> bool:
        with self._lock:
            return version in self._versions

    def __len__(self) -> int:
        with self._lock:
            return len(self._versions)
