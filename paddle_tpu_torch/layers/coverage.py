"""Reader-layer surface of ``paddle_tpu.layers.coverage`` (reference
``layers/io.py``): ``py_reader``, ``create_py_reader_by_data`` and
``double_buffer``. The rest of the JAX package's coverage layers are not
ported yet (ROADMAP A12).

Each takes a ``place``: the double buffer puts batches on it, on
``CUDAPlace(0)`` unless the caller passes another place (``CPUPlace()``
for the CPU).
"""
from __future__ import annotations

__all__ = ["py_reader", "create_py_reader_by_data", "double_buffer"]


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True, place=None):
    """layers/io.py py_reader: returns a PyReader-compatible object (the
    reader variable of the reference maps to the host-side PyReader here;
    use_double_buffer engages the dataio.DeviceLoader prefetch stage)."""
    from ..reader import PyReader
    return PyReader(feed_list=None, capacity=capacity, shapes=shapes,
                    dtypes=dtypes, name=name,
                    use_double_buffer=use_double_buffer, place=place)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True, place=None):
    from ..reader import PyReader
    return PyReader(feed_list=feed_list, capacity=capacity, name=name,
                    use_double_buffer=use_double_buffer, place=place)


def double_buffer(reader, place=None, name=None):
    """buffered_reader.cc parity: wrap a batch reader so the conversion and
    the H2D copy of the next batch run on a dataio.DeviceLoader worker
    while the current step computes. Returns a reader callable; each call
    is one prefetched epoch. The place is resolved here, so with no GPU
    and no place this raises at once."""
    from ..core.executor import CUDAPlace
    from ..dataio import DeviceLoader

    place = place or CUDAPlace(0)
    place.torch_device()

    def double_buffered():
        loader = DeviceLoader(reader, capacity=2,
                              name=name or "double_buffer", place=place)
        yield from loader

    return double_buffered
