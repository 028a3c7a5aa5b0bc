"""Sampled classifiers of ``paddle_tpu.ops.sampled_ops`` (reference
nce_op.cc/.h): ``nce``, which the dygraph layer zoo traces, and
``max_sequence_len`` (max_sequence_len_op.cc), which the recurrent layers
use. The rest of the module is not ported yet (ROADMAP A12).

The noise samples come from the run's ``torch.Generator``
(``ctx.rng()``); the JAX package draws them from its PRNG key, so the two
packages draw different negatives by design, and parity checks evaluate
the JAX formula on the negatives the port drew (``SampleLabels``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import ROWS, register_op
from .common import one


@register_op("max_sequence_len", differentiable=False)
def _max_sequence_len(ctx, inputs, attrs):
    """The longest row of a [B] length vector, as a [1] int64 tensor on
    the device (the padded stand-in for the reference's rank table)."""
    (lens,) = inputs["RankTable"]
    return one(torch.amax(lens).reshape(1).to(torch.int64))


@register_op("nce", nondiff_inputs=["Label", "SampleWeight",
                                    "CustomDistProbs", "CustomDistAlias",
                                    "CustomDistAliasProbs"], dp=ROWS)
def _nce(ctx, inputs, attrs):
    """nce_op.h: binary logistic loss on the true classes + k noise samples
    (sampler 0 = uniform, the default; 1 = log_uniform; 2 = custom_dist
    from CustomDistProbs)."""
    (x,) = inputs["Input"]
    (w,) = inputs["Weight"]                # [num_total_classes, D]
    (label,) = inputs["Label"]
    bias = inputs.get("Bias")
    num_total = int(attrs["num_total_classes"])
    k = int(attrs.get("num_neg_samples", 10))
    sampler = int(attrs.get("sampler", 0))
    b = x.shape[0]
    lab = label.reshape(b, -1).long()
    num_true = lab.shape[1]
    gen = ctx.rng()
    if sampler == 1:
        # log_uniform (nce_op.h:51 LogUniformSampler): Zipfian
        # P(c) = log((c+2)/(c+1)) / log(range+1); inverse-CDF draw
        u = torch.rand((b, k), generator=gen, device=gen.device).to(x.device)
        rng_log = math.log(num_total + 1)
        neg = (torch.exp(u * rng_log) - 1.0).long().clamp(0, num_total - 1)

        def q_of(ids):
            idf = ids.float()
            return (torch.log(idf + 2.0) - torch.log(idf + 1.0)) / rng_log
    elif sampler == 2:
        (probs,) = inputs["CustomDistProbs"]
        probs = probs.reshape(-1).float()
        neg = torch.multinomial(probs.to(gen.device), b * k, replacement=True,
                                generator=gen).reshape(b, k).to(x.device)

        def q_of(ids):
            return probs[ids]
    else:
        neg = torch.randint(0, num_total, (b, k), generator=gen,
                            device=gen.device).to(x.device)

        def q_of(ids):
            return torch.full(ids.shape, 1.0 / num_total,
                              dtype=torch.float32, device=ids.device)
    samples = torch.cat([lab, neg], dim=1)              # [B, T+k]
    ws = w[samples]                                     # [B, T+k, D]
    logits = torch.einsum("btd,bd->bt", ws, x)
    if bias:
        logits = logits + bias[0].reshape(-1)[samples]
    p_true = 1.0 / num_true if num_true else 1.0
    lt = logits[:, :num_true]
    ln = logits[:, num_true:]
    # P(D=1|x) = σ(logit − log(k·q(class)))
    shift_t = torch.log(k * q_of(samples[:, :num_true]) + 1e-20)
    shift_n = torch.log(k * q_of(samples[:, num_true:]) + 1e-20)
    pos = F.softplus(-(lt - shift_t))
    negl = F.softplus(ln - shift_n)
    cost = (pos.sum(1, keepdim=True) * p_true
            + negl.sum(1, keepdim=True))
    return {"Cost": [cost], "SampleLogits": [logits.detach()],
            "SampleLabels": [samples.detach()]}
