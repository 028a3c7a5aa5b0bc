"""The beam-search layers of ``paddle_tpu.layers.rnn`` (reference
``layers/control_flow.py`` beam_search / beam_search_decode wrappers), over
the dense beams of ``ops/beam_ops.py``. The recurrent layers of that module
(dynamic_lstm, dynamic_gru, the units, lstm) are not ported yet (ROADMAP
A12)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["beam_search", "beam_search_decode"]


def beam_search(pre_ids, pre_scores, scores, beam_size: int, end_id: int,
                pre_finished=None, name=None):
    """One beam expansion step over dense [batch, beam, vocab] log-probs
    (reference beam_search_op.cc; LoD beams → dense beams, see ops/beam_ops).
    Returns (selected_ids, selected_scores, parent_idx, finished)."""
    helper = LayerHelper("beam_search", name=name)
    ids = helper.create_variable_for_type_inference("int64")
    sel_scores = helper.create_variable_for_type_inference(scores.dtype)
    parent = helper.create_variable_for_type_inference("int64")
    finished = helper.create_variable_for_type_inference("bool")
    inputs = {"Scores": [scores.name], "PreScores": [pre_scores.name]}
    if pre_finished is not None:
        inputs["PreFinished"] = [pre_finished.name]
    helper.append_op(
        type="beam_search", inputs=inputs,
        outputs={"SelectedIds": [ids.name], "SelectedScores": [sel_scores.name],
                 "ParentIdx": [parent.name], "Finished": [finished.name]},
        attrs={"beam_size": beam_size, "end_id": end_id})
    return ids, sel_scores, parent, finished


def beam_search_decode(ids, parent_idx, scores, beam_size: int = None,
                       end_id: int = None, name=None):
    """Backtrack stored [T, batch, beam] steps into [batch, beam, T] token
    sequences (reference beam_search_decode_op.cc)."""
    helper = LayerHelper("beam_search_decode", name=name)
    sentences = helper.create_variable_for_type_inference("int64")
    sent_scores = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids.name], "ParentIdx": [parent_idx.name],
                "Scores": [scores.name]},
        outputs={"SentenceIds": [sentences.name],
                 "SentenceScores": [sent_scores.name]},
        attrs={})
    return sentences, sent_scores
