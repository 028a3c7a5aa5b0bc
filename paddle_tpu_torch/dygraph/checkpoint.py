"""save_dygraph / load_dygraph (the port's copy of
``paddle_tpu.dygraph.checkpoint``; reference dygraph/checkpoint.py): a
pickled dict of numpy arrays, the JAX package's format, so a file either
package writes loads into the other."""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np


def save_dygraph(state_dict: Dict, model_path: str):
    """state_dict: Layer.state_dict() → <path>.pdparams; optimizer
    .state_dict() (carries the '@optimizer_state@' marker) → <path>.pdopt —
    so the reference's save-both-to-one-prefix pattern round-trips."""
    is_opt = "@optimizer_state@" in state_dict
    path = model_path + (".pdopt" if is_opt else ".pdparams")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in state_dict.items()}
    with open(path, "wb") as f:
        pickle.dump(arrays, f, protocol=4)


def load_dygraph(model_path: str) -> Tuple[Optional[Dict], Optional[Dict]]:
    para_path = model_path + ".pdparams"
    opt_path = model_path + ".pdopt"
    para = opt = None
    if os.path.exists(para_path):
        with open(para_path, "rb") as f:
            para = pickle.load(f)
    if os.path.exists(opt_path):
        with open(opt_path, "rb") as f:
            opt = pickle.load(f)
    return para, opt
