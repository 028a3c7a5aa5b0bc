"""contrib seq2seq decoder API (counterpart of
``paddle_tpu.contrib.decoder``; reference
``python/paddle/fluid/contrib/decoder/beam_search_decoder.py``: InitState,
StateCell, TrainingDecoder, BeamSearchDecoder).

The training decoder steps its state cell through ``layers.StaticRNN``
(one ``static_rnn`` op; the reference uses a LoD-driven DynamicRNN). The
beam decoder is unrolled in Python over `max_len` steps at build time:
each step records the cell's ops and one ``beam_search`` op, and the steps
are stacked into one ``beam_search_decode``, as the JAX package builds it.
"""
from __future__ import annotations

from ..layers import control_flow as cf
from ..layers import nn as nn_layers
from ..layers import rnn as rnn_layers
from ..layers import tensor as tensor_layers


class InitState:
    """beam_search_decoder.py InitState: initial decoder state, either a
    given Variable or zeros shaped from a batch reference."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is not None:
            self._init = tensor_layers.fill_constant_batch_size_like(
                init_boot, shape or [-1, 1], dtype, value)
        else:
            raise ValueError("init or init_boot must be provided")

    @property
    def value(self):
        return self._init


class StateCell:
    """beam_search_decoder.py StateCell: named states + named inputs driving
    a user compute function per step."""

    def __init__(self, inputs, states, out_state, name=None):
        self._input_names = dict(inputs)   # name -> placeholder (None ok)
        self._init_states = dict(states)   # name -> InitState
        self._out_state = out_state
        self._cur_states = {}
        self._cur_inputs = {}
        self._compute = None

    def register_updater(self, fn):
        self._compute = fn
        return fn

    # -- step-time API (used inside the decoder loop / user fn) -------------
    def get_state(self, name):
        return self._cur_states[name]

    def get_input(self, name):
        return self._cur_inputs[name]

    def set_state(self, name, value):
        self._cur_states[name] = value

    def compute_state(self, inputs):
        self._cur_inputs = dict(inputs)
        if self._compute is None:
            raise RuntimeError("no updater registered (use "
                               "@state_cell.register_updater)")
        self._compute(self)

    def update_states(self):
        pass  # states already swapped by set_state

    def out_state(self):
        return self._cur_states[self._out_state]


class TrainingDecoder:
    """beam_search_decoder.py TrainingDecoder: teacher-forced decode loop.

    Usage::

        decoder = TrainingDecoder(state_cell)
        with decoder.block():
            w = decoder.step_input(trg_embedding)     # [B, T, D] → per-step
            state_cell.compute_state(inputs={"x": w})
            decoder.output(some_projection(state_cell.get_state("h")))
            state_cell.update_states()
        out = decoder()                                # [B, T, ...]
    """

    def __init__(self, state_cell, name=None):
        self._cell = state_cell
        self._rnn = cf.StaticRNN()
        self._outputs = []
        self._entered = False

    def block(self):
        outer = self

        class _Ctx:
            def __enter__(self):
                outer._step_ctx = outer._rnn.step()
                outer._step_ctx.__enter__()
                # memories for every registered state
                outer._mems = {}
                for n, st in outer._cell._init_states.items():
                    mem = outer._rnn.memory(init=st.value)
                    outer._mems[n] = mem
                    outer._cell._cur_states[n] = mem
                return outer

            def __exit__(self, *exc):
                if not any(exc):
                    for n, mem in outer._mems.items():
                        outer._rnn.update_memory(mem,
                                                 outer._cell._cur_states[n])
                return outer._step_ctx.__exit__(*exc)

        return _Ctx()

    def step_input(self, x):
        return self._rnn.step_input(x)

    def static_input(self, x):
        return x

    def output(self, *outputs):
        for o in outputs:
            self._rnn.output(o)
        self._outputs.extend(outputs)

    def __call__(self):
        outs = self._rnn()
        return outs if isinstance(outs, (list, tuple)) and len(outs) > 1 \
            else (outs[0] if isinstance(outs, (list, tuple)) else outs)


class BeamSearchDecoder:
    """beam_search_decoder.py BeamSearchDecoder: beam decode driven by the
    same state cell. Bounded unrolled loop (max_len steps) over the
    beam_search op; call `decode()` then `()` for (ids, scores)."""

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50,
                 sparse_emb=True, max_candidate_num=None, end_id=1,
                 beam_size=4, max_len=16, embedding_fn=None, score_fn=None,
                 name=None):
        self._cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._beam_size = beam_size
        self._end_id = end_id
        self._max_len = max_len
        self._embedding_fn = embedding_fn
        self._score_fn = score_fn
        self._decoded = None

    def decode(self):
        if self._embedding_fn is None or self._score_fn is None:
            raise ValueError(
                "BeamSearchDecoder here needs embedding_fn (ids → input "
                "dict for the state cell) and score_fn (out state → log "
                "probs over the vocab)")
        ids, scores = self._init_ids, self._init_scores
        # seed the cell's live states from their InitState values (the
        # TrainingDecoder does this inside its RNN block; the beam loop is
        # build-time Python, so plain assignment is the equivalent)
        for n, st in self._cell._init_states.items():
            self._cell._cur_states[n] = st.value
        all_ids, all_parents, all_scores = [], [], []
        for step in range(self._max_len):
            inp = self._embedding_fn(ids)
            self._cell.compute_state(inputs=inp)
            logprob = self._score_fn(self._cell.out_state())
            sel_ids, sel_scores, parent, _fin = rnn_layers.beam_search(
                ids, scores, logprob, beam_size=self._beam_size,
                end_id=self._end_id)
            all_ids.append(sel_ids)
            all_parents.append(parent)
            all_scores.append(sel_scores)
            ids, scores = sel_ids, sel_scores
            self._cell.update_states()
        self._decoded = (all_ids, all_parents, all_scores)
        return self

    def __call__(self):
        if self._decoded is None:
            raise RuntimeError("call decode() first")
        all_ids, all_parents, all_scores = self._decoded
        ids = tensor_layers.stack(all_ids, axis=0)
        parents = tensor_layers.stack(all_parents, axis=0)
        scores = tensor_layers.stack(all_scores, axis=0)
        return rnn_layers.beam_search_decode(
            ids, parents, scores, beam_size=self._beam_size,
            end_id=self._end_id)
