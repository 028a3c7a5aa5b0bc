"""fluid.distribute_lookup_table (reference distribute_lookup_table.py; the
port's copy of ``paddle_tpu.distribute_lookup_table``)."""
from __future__ import annotations

__all__ = ["find_distributed_lookup_table"]

LOOKUP_TABLE_TYPE = "lookup_table"


def find_distributed_lookup_table(program):
    """Return the (single) distributed lookup table parameter name, or None
    — the reference's transpiler helper, used to route a sparse table to
    pservers; here it identifies the table to shard over the tp axis."""
    table_name = None
    for op in program.global_block().ops:
        if op.type == LOOKUP_TABLE_TYPE and op.attrs.get("is_distributed"):
            name = op.inputs["W"][0]
            if table_name is None:
                table_name = name
            elif table_name != name:
                raise RuntimeError(
                    "all distributed lookup_table ops must share one table")
    return table_name
