"""Semantic-role labelling: the reference book chapter's ``db_lstm``
(``python/paddle/fluid/tests/book/test_label_semantic_roles.py``): eight
embeddings (six word/context slots sharing one frozen table, the
predicate, the mark), one ``fc(tanh)`` each summed, a stack of `depth`
LSTMs whose directions alternate, each fed the sum of two ``fc(tanh)`` of
the level below, then an emission of ``label_dict_len`` columns, a
linear-chain CRF and Viterbi decoding with the same transition ``crfw``.

Sequences are padded ``[B, T]`` id batches with a ``length [B]`` feed
(the reference feeds LoD rows). The builders take the package to build
with (``fl``, this port by default): the DSL is the JAX package's, so a
test can build the same program in both and start them from one state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# the feeds, in the book's order
WORD_SLOTS = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")
FEEDS = WORD_SLOTS + ("predicate", "mark", "target", "length")


@dataclass
class SRLConfig:
    """conll05's vocabularies and the book's widths by default."""
    word_dict_len: int = 44068
    pred_dict_len: int = 3162
    mark_dict_len: int = 2
    label_dict_len: int = 59
    word_dim: int = 32
    mark_dim: int = 5
    hidden_dim: int = 512        # the LSTM's 4H: H = 128
    depth: int = 8
    mix_hidden_lr: float = 1e-3
    learning_rate: float = 0.01

    @property
    def num_chunk_types(self) -> int:
        return int(math.ceil((self.label_dict_len - 1) / 2.0))


def _package(fl):
    if fl is None:
        import paddle_tpu_torch as fl
    return fl


def _sums(fl, xs):
    """`layers.sums` with the static shape of its first input (the JAX
    package's `sums` leaves it unset, and the fc after it needs it)."""
    out = fl.layers.sums(xs)
    if out.shape is None:
        out.shape = xs[0].shape
    return out


def db_lstm(cfg: SRLConfig, feeds, fl=None):
    """The emission [B, T, label_dict_len] of the book's network over the
    `feeds` vars (a dict by name, see FEEDS)."""
    fl = _package(fl)
    L = fl.layers
    length = feeds["length"]
    pred_emb = L.embedding(feeds["predicate"],
                           size=[cfg.pred_dict_len, cfg.word_dim],
                           param_attr="vemb")
    mark_emb = L.embedding(feeds["mark"],
                           size=[cfg.mark_dict_len, cfg.mark_dim])
    embs = [L.embedding(feeds[s], size=[cfg.word_dict_len, cfg.word_dim],
                        param_attr=fl.ParamAttr(name="emb",
                                                trainable=False))
            for s in WORD_SLOTS] + [pred_emb, mark_emb]
    hidden_0 = _sums(fl, [L.fc(e, size=cfg.hidden_dim, act="tanh",
                               num_flatten_dims=2) for e in embs])
    lstm_0, _ = L.dynamic_lstm(hidden_0, size=cfg.hidden_dim, length=length,
                               candidate_activation="relu",
                               gate_activation="sigmoid",
                               cell_activation="sigmoid")
    below = [hidden_0, lstm_0]
    for i in range(1, cfg.depth):
        mix = _sums(fl, [L.fc(v, size=cfg.hidden_dim, act="tanh",
                              num_flatten_dims=2) for v in below])
        lstm, _ = L.dynamic_lstm(mix, size=cfg.hidden_dim, length=length,
                                 candidate_activation="relu",
                                 gate_activation="sigmoid",
                                 cell_activation="sigmoid",
                                 is_reverse=(i % 2) == 1)
        below = [mix, lstm]
    return _sums(fl, [L.fc(v, size=cfg.label_dict_len, act="tanh",
                           num_flatten_dims=2) for v in below])


def data_vars(fl=None):
    fl = _package(fl)
    out = {n: fl.layers.data(n, shape=[-1, -1], dtype="int64",
                             append_batch_size=False)
           for n in FEEDS if n != "length"}
    out["length"] = fl.layers.data("length", shape=[-1], dtype="int64",
                                   append_batch_size=False)
    return out


def build_train_program(cfg: SRLConfig, fl=None):
    """(main, startup, avg_cost): the CRF's mean negative log-likelihood
    under SGD on the book's exponential decay; `crfw` carries the book's
    learning-rate attribute (neither package applies per-parameter rates)."""
    fl = _package(fl)
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        feeds = data_vars(fl)
        emission = db_lstm(cfg, feeds, fl)
        crf_cost = fl.layers.linear_chain_crf(
            emission, feeds["target"], length=feeds["length"],
            param_attr=fl.ParamAttr(name="crfw",
                                    learning_rate=cfg.mix_hidden_lr))
        avg_cost = fl.layers.mean(crf_cost)
        fl.optimizer.SGD(learning_rate=fl.layers.exponential_decay(
            learning_rate=cfg.learning_rate, decay_steps=100000,
            decay_rate=0.5, staircase=True)).minimize(avg_cost)
    return main, startup, avg_cost


def build_decode_program(cfg: SRLConfig, fl=None):
    """(program, path, (precision, recall, f1, n_infer, n_label,
    n_correct)): Viterbi decoding with the trained `crfw` and chunk_eval
    (IOB) of the path against `target`. Build it under a fresh unique-name
    guard, as the training program, so its parameters are named alike."""
    fl = _package(fl)
    prog, startup = fl.Program(), fl.Program()
    with fl.program_guard(prog, startup):
        feeds = data_vars(fl)
        emission = db_lstm(cfg, feeds, fl)
        path = fl.layers.crf_decoding(
            emission, param_attr=fl.ParamAttr(name="crfw"),
            length=feeds["length"])
        chunks = fl.layers.chunk_eval(
            path, feeds["target"], chunk_scheme="IOB",
            num_chunk_types=cfg.num_chunk_types, seq_length=feeds["length"])
    return prog, path, chunks


def make_batch(cfg: SRLConfig, batch: int, seed: int, min_len: int = 8,
               max_len: int = 64):
    """A seeded batch: lengths uniform in [min_len, max_len], ids uniform
    over each vocabulary, padded with 0 to the longest row."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(min_len, max_len + 1, size=batch)
    T = int(lengths.max())
    valid = np.arange(T)[None, :] < lengths[:, None]

    def ids(hi):
        return np.where(valid, rng.randint(0, hi, size=(batch, T)),
                        0).astype(np.int64)

    feed = {s: ids(cfg.word_dict_len) for s in WORD_SLOTS}
    feed["predicate"] = ids(cfg.pred_dict_len)
    feed["mark"] = ids(cfg.mark_dict_len)
    feed["target"] = ids(cfg.label_dict_len)
    feed["length"] = lengths.astype(np.int64)
    return feed
