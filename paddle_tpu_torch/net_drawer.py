"""fluid.net_drawer (reference net_drawer.py draw_graph) over the
debugger's graphviz emitters; a copy of ``paddle_tpu.net_drawer``."""
from __future__ import annotations

from . import debugger as _debugger

__all__ = ["draw_graph"]


def draw_graph(startup_program, main_program, **kwargs):
    """net_drawer.py draw_graph: emit graphviz dot for the main program
    (startup accepted for API parity; its init ops aren't drawn)."""
    path = kwargs.get("graph_path") or kwargs.get("path")
    dot = _debugger.program_to_dot(main_program)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
