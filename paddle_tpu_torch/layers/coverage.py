"""Part of ``paddle_tpu.layers.coverage``: the reader layers (reference
``layers/io.py``: ``py_reader``, ``create_py_reader_by_data``,
``double_buffer``) and the layout layers the space-to-depth ResNet stem
uses (``pad``, ``pad2d``, ``space_to_depth``). The rest of the JAX
package's coverage layers are not ported yet (ROADMAP A12).

The reader layers take a ``place``: the double buffer puts batches on it,
on ``CUDAPlace(0)`` unless the caller passes another place (``CPUPlace()``
for the CPU).
"""
from __future__ import annotations

from ..core.program import Variable
from ..layer_helper import LayerHelper

__all__ = ["py_reader", "create_py_reader_by_data", "double_buffer", "pad",
           "pad2d", "space_to_depth"]


def _emit(op_type, x, attrs, name=None, out_shape=None):
    """Append one single-input op on X; `out_shape` is the result's static
    shape metadata (as in the JAX package)."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    helper.append_op(type=op_type, inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    shp = None
    if x.shape is not None and len(paddings) == 2 * len(x.shape):
        shp = tuple(
            None if d is None or int(d) < 0
            else int(d) + paddings[2 * i] + paddings[2 * i + 1]
            for i, d in enumerate(x.shape))
    return _emit("pad", x, {"paddings": list(paddings),
                            "pad_value": pad_value},
                 name=name, out_shape=shp)


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    shp = None
    if input.shape is not None and len(input.shape) == 4 \
            and not isinstance(paddings, Variable):
        t, b, l, r = paddings
        n, c, h, w = input.shape
        shp = (n, c, (h + t + b) if h and h > 0 else h,
               (w + l + r) if w and w > 0 else w)
    return _emit("pad2d", input,
                 {"paddings": list(paddings), "mode": mode,
                  "pad_value": pad_value, "data_format": data_format},
                 name=name, out_shape=shp)


def space_to_depth(x, blocksize, name=None):
    shp = None
    if x.shape is not None and len(x.shape) == 4:
        n, c, h, w = x.shape
        bs = int(blocksize)
        shp = (n, None if c is None else c * bs * bs,
               None if h is None else h // bs,
               None if w is None else w // bs)
    return _emit("space_to_depth", x, {"blocksize": blocksize}, name=name,
                 out_shape=shp)


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
