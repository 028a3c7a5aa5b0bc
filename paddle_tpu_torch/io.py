"""Parameter and inference-model serialization (counterpart of
``paddle_tpu.io``; reference ``python/paddle/fluid/io.py`` save_vars:128,
load_vars:537, save_inference_model:933, load_inference_model:1113).

The on-disk format is the JAX package's: a JSON ``__model__`` from
``Program.to_dict`` and a pickled dict of numpy arrays in ``__params__``
(or one pickle per var). Either package serves a model directory the other
saved. ``save_inference_model(format="reference")`` writes the reference
framework's protobuf ``__model__`` and LoDTensor streams instead
(``compat/``), and ``compat.load_reference_inference_model`` reads them;
``load_inference_model`` reads the JSON format only, as the JAX package's
does. Training checkpoints live in ``parallel/checkpoint.py``.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .core.dtypes import from_numpy, to_numpy
from .core.program import Program, Variable, default_main_program
from .core.scope import Scope, _scope


def _persistable_vars(program: Program):
    return [v for v in program.list_vars()
            if v.persistable and not v.name.startswith("@")]


def _executor_device(executor):
    return getattr(executor, "device", None) or torch.device("cpu")


def _host_array(program: Program, name: str, val) -> np.ndarray:
    """A scope value as a numpy array. After a mesh run a value split over
    an axis (a ``DTensor``) or held by one pipeline stage's ranks (a
    ``StageValue``) is made whole first (``mesh_step.logical_value``): that
    takes collectives, so on a mesh every rank saves, at the same point."""
    from .core.mesh_step import logical_value

    return to_numpy(logical_value(program, name, val))


def _dump(path: str, obj):
    """Pickle `obj` to `path` through a file of this process's own, moved
    into place: the ranks of a mesh write the same files."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, protocol=4)
    os.replace(tmp, path)


def save_vars(executor, dirname: str, main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None, predicate=None,
              filename: Optional[str] = None):
    """Save vars of the current scope. After a mesh run, every rank of the
    mesh calls it (see ``_host_array``) and writes the same whole values."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars() if (predicate or (lambda v: v.persistable))(v)]
    scope = _scope()
    os.makedirs(dirname, exist_ok=True)
    bundle = {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            continue
        bundle[v.name] = _host_array(main_program, v.name, val)
    if filename is not None:
        _dump(os.path.join(dirname, filename), bundle)
    else:
        for name, arr in bundle.items():
            _dump(os.path.join(dirname, name.replace("/", "_")), {name: arr})


def save_persistables(executor, dirname: str,
                      main_program: Optional[Program] = None,
                      filename: Optional[str] = None):
    """io.py:487 parity."""
    main_program = main_program or default_main_program()
    save_vars(executor, dirname, main_program,
              vars=_persistable_vars(main_program), filename=filename)


save_params = save_persistables


def load_vars(executor, dirname: str, main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None, predicate=None,
              filename: Optional[str] = None):
    """Load vars into the current scope, on `executor`'s device (the CPU
    when `executor` is None). Returns the names that were not found."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars() if (predicate or (lambda v: v.persistable))(v)]
    if filename is not None:
        with open(os.path.join(dirname, filename), "rb") as f:
            bundle = pickle.load(f)
    else:
        bundle = {}
        for v in vars:
            p = os.path.join(dirname, v.name.replace("/", "_"))
            if os.path.exists(p):
                with open(p, "rb") as f:
                    bundle.update(pickle.load(f))
    missing = [v.name for v in vars if v.name not in bundle]
    load_params_from_numpy({v.name: bundle[v.name] for v in vars
                            if v.name in bundle},
                           device=_executor_device(executor))
    return missing


def load_persistables(executor, dirname: str,
                      main_program: Optional[Program] = None,
                      filename: Optional[str] = None):
    """io.py:726 parity: onto `executor`'s device. Returns the names that
    were not found."""
    main_program = main_program or default_main_program()
    return load_vars(executor, dirname, main_program,
                     vars=_persistable_vars(main_program), filename=filename)


load_params = load_persistables


def load_params_from_numpy(arrays: Dict[str, np.ndarray],
                           scope: Optional[Scope] = None, device=None):
    """Set each array as a tensor of the same name in `scope` (the current
    scope by default), on `device` (the CPU by default). This carries every
    persistable across from the JAX package, whose vars are named the same
    way: parameters, optimizer state (Adam moments, beta powers), the
    learning-rate var, loss-scaling counters. ml_dtypes bfloat16 arrays go
    through a uint16 view."""
    scope = scope or _scope()
    for name, arr in arrays.items():
        scope.set_var(name, from_numpy(arr, device=device))


def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable], executor,
                         main_program: Optional[Program] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         export_for_deployment: bool = True,
                         format: str = "native"):
    """io.py:933 parity: prune to feed→fetch, save program + params.

    ``format="reference"`` writes the artifact in the REFERENCE's binary
    formats instead (protobuf ProgramDesc ``__model__`` + LoDTensor var
    streams, ``compat.export_reference_inference_model``), so the
    reference's own loader, and ``inference.create_predictor``, serve a
    model trained here."""
    if format not in ("native", "reference"):
        raise ValueError(f"save_inference_model: unknown format {format!r} "
                         "(use 'native' or 'reference')")
    if format == "reference" and model_filename is not None:
        raise ValueError(
            "save_inference_model(format='reference') always writes the "
            "reference loader's default '__model__' file; model_filename "
            "is not supported there")
    main_program = main_program or default_main_program()
    fetch_names = [t.name for t in target_vars]
    blk = main_program.global_block()
    missing = [n for n in fetch_names if not blk.has_var(n)]
    if missing:
        raise ValueError(
            f"target_vars {missing} are not in main_program — were they "
            f"created under a different program (check program_guard scope)?")
    pruned = main_program._prune_for_inference(feeded_var_names, fetch_names)
    if format == "reference":
        from .compat import export_reference_inference_model
        return export_reference_inference_model(
            dirname, feeded_var_names, fetch_names, pruned,
            params_filename=params_filename)
    os.makedirs(dirname, exist_ok=True)
    model = {
        "program": pruned.to_dict(),
        "feed_names": list(feeded_var_names),
        "fetch_names": fetch_names,
    }
    with open(os.path.join(dirname, model_filename or "__model__"), "w") as f:
        json.dump(model, f)
    save_vars(executor, dirname, pruned, vars=_persistable_vars(pruned),
              filename=params_filename or "__params__")
    return fetch_names


def _is_reference_model_file(path: str) -> bool:
    """The reference's binary-protobuf __model__ starts with a field tag
    (0x0a); this format's JSON model starts with '{'."""
    try:
        with open(path, "rb") as f:
            head = f.read(1)
    except OSError:
        return False
    return bool(head) and head != b"{"


def load_inference_model(dirname: str, executor,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None):
    """io.py:1113 parity: returns (program, feed_names, fetch_vars)."""
    path = os.path.join(dirname, model_filename or "__model__")
    if _is_reference_model_file(path):
        raise NotImplementedError(
            f"{path} is in the reference framework's protobuf format; "
            f"io.load_inference_model reads only the JSON format that "
            f"save_inference_model writes: load it with "
            f"compat.load_reference_inference_model(dirname, place=...), or "
            f"serve it with inference.create_predictor(Config(dirname))")
    with open(path) as f:
        model = json.load(f)
    program = Program.from_dict(model["program"])
    load_vars(executor, dirname, program, vars=_persistable_vars(program),
              filename=params_filename or "__params__")
    fetch_vars = [program.global_block().var(n) for n in model["fetch_names"]]
    return program, model["feed_names"], fetch_vars
