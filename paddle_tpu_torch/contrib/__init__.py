"""Contrib modules of the port: mixed precision, the basic RNN units and
stacks (``contrib.layers``) and the seq2seq decoder API
(``contrib.decoder``)."""
from . import mixed_precision  # noqa: F401
from . import layers  # noqa: F401
from .decoder import (  # noqa: F401
    BeamSearchDecoder, InitState, StateCell, TrainingDecoder)
from .layers import BasicGRUUnit, BasicLSTMUnit, basic_gru, basic_lstm  # noqa: F401
