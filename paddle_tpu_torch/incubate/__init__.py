"""fluid.incubate (reference python/paddle/fluid/incubate/ — fleet package +
data_generator)."""
from .. import data_generator  # noqa: F401
from . import fleet  # noqa: F401
