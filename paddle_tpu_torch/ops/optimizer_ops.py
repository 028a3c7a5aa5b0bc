"""Optimizer update ops (counterpart of the dense registrations in
``paddle_tpu.ops.optimizer_ops``; reference
``paddle/fluid/operators/optimizers/``: sgd_op.cc, adam_op.cc, lamb_op.cc).

All are non-differentiable state-update ops: they read Param/Grad/
accumulators and return the updated values under the same var names, which
the executor writes back to the scope. The executor runs them under
``torch.no_grad()`` after the autodiff op, so the updates record no graph.
Only dense gradients are ported: a sparse (``is_sparse``) embedding raises
in training (``nn_ops.lookup_table``), and the SelectedRows row-update
kernels come with the DeepFM slice.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _lr(inputs):
    (lr,) = inputs["LearningRate"]
    return lr.reshape(())


@register_op("sgd", differentiable=False)
def _sgd(ctx, inputs, attrs):
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    return {"ParamOut": [p - _lr(inputs) * g.to(p.dtype)]}


def _adam_moments(inputs, attrs, p, g):
    (m,) = inputs["Moment1"]
    (v,) = inputs["Moment2"]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    g = g.to(p.dtype)
    return b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g


def _beta_pows(inputs, attrs):
    (b1p,) = inputs["Beta1Pow"]
    (b2p,) = inputs["Beta2Pow"]
    return (b1p, b2p, b1p * attrs.get("beta1", 0.9),
            b2p * attrs.get("beta2", 0.999))


@register_op("adam", differentiable=False)
def _adam(ctx, inputs, attrs):
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    b1p, b2p, b1p_out, b2p_out = _beta_pows(inputs, attrs)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = _lr(inputs) * torch.sqrt(1 - b2p.reshape(())) / (
        1 - b1p.reshape(()))
    m_out, v_out = _adam_moments(inputs, attrs, p, g)
    p_out = p - lr_t * m_out / (torch.sqrt(v_out) + eps)
    return {
        "ParamOut": [p_out], "Moment1Out": [m_out], "Moment2Out": [v_out],
        "Beta1PowOut": [b1p_out], "Beta2PowOut": [b2p_out],
    }


@register_op("adamw", differentiable=False)
def _adamw(ctx, inputs, attrs):
    """Decoupled weight decay variant (beyond-reference; standard for BERT)."""
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    b1p, b2p, b1p_out, b2p_out = _beta_pows(inputs, attrs)
    eps = attrs.get("epsilon", 1e-8)
    wd = attrs.get("coeff", 0.01)
    lr = _lr(inputs)
    m_out, v_out = _adam_moments(inputs, attrs, p, g)
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    p_out = p - lr_t * (m_out / (torch.sqrt(v_out) + eps)) - lr * wd * p
    return {
        "ParamOut": [p_out], "Moment1Out": [m_out], "Moment2Out": [v_out],
        "Beta1PowOut": [b1p_out], "Beta2PowOut": [b2p_out],
    }


@register_op("lamb", differentiable=False)
def _lamb(ctx, inputs, attrs):
    """lamb_op.cc: layer-wise adaptation for large batches (BERT-scale)."""
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    b1p, b2p, b1p_out, b2p_out = _beta_pows(inputs, attrs)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    lr = _lr(inputs)
    m_out, v_out = _adam_moments(inputs, attrs, p, g)
    m_hat = m_out / (1 - b1p.reshape(()))
    v_hat = v_out / (1 - b2p.reshape(()))
    r = m_hat / (torch.sqrt(v_hat) + eps) + wd * p
    p_norm = torch.sqrt(torch.sum(p * p))
    r_norm = torch.sqrt(torch.sum(r * r))
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    return {
        "ParamOut": [p - lr * trust * r], "Moment1Out": [m_out],
        "Moment2Out": [v_out], "Beta1PowOut": [b1p_out],
        "Beta2PowOut": [b2p_out],
    }
