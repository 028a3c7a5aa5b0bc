"""Optimizer update ops (counterpart of the dense registrations in
``paddle_tpu.ops.optimizer_ops``; reference
``paddle/fluid/operators/optimizers/``: sgd_op.cc, momentum_op.cc,
lars_momentum_op.cc, adam_op.cc, adamax_op.cc, lamb_op.cc, adagrad_op.cc,
decayed_adagrad_op.cc, adadelta_op.cc, rmsprop_op.cc, ftrl_op.cc).

All are non-differentiable state-update ops: they read Param/Grad/
accumulators and return the updated values under the same var names, which
the executor writes back to the scope. The executor runs them under
``torch.no_grad()`` after the autodiff op, so the updates record no graph.
A ``SelectedRows`` gradient (an ``is_sparse`` embedding) updates only the
touched rows of sgd, adam (lazy mode) and adagrad: duplicates are merged
first (``SelectedRows.merged``: every duplicate position carries its id's
full sum), so the row writes are the same whichever duplicate lands last.
The packed-table row ops are in ``ops/deferred_rows.py``.

Each op keeps the JAX function's operation order term by term, and takes
the correctly rounded ``sqrt_rn`` where the JAX function takes
``jnp.sqrt`` of a tensor (torch's vectorized CPU float32 sqrt can be 1 ULP
off). The learning rate is a device tensor: no op reads a value back to
the host.

``sgd_list`` and ``momentum_list`` are the dense sgd and momentum updates
of a parameter list (the executor's update-group fusion,
``PDTPU_FUSE_UPDATES``): ``torch._foreach_*`` over the lists, in the same
operation order as the per-op function beside them, so a fused group is
bitwise equal to its ops run one by one, on the CPU and on the card.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows
from .kernels.sparse_adagrad import sqrt_rn


def _lr(inputs):
    (lr,) = inputs["LearningRate"]
    return lr.reshape(())


@register_op("sgd", differentiable=False)
def _sgd(ctx, inputs, attrs):
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    if isinstance(g, SelectedRows):
        # sgd_op.cc SelectedRows kernel: touched rows only
        ids, rows = g.merged()
        return {"ParamOut": [p.index_copy(
            0, ids, p[ids] - _lr(inputs) * rows.to(p.dtype))]}
    return {"ParamOut": [p - _lr(inputs) * g.to(p.dtype)]}


def sgd_list(params, grads, lr):
    """`_sgd`'s dense update of a parameter list; `lr` is a 0-dim tensor
    (the Tensor overload of ``_foreach_mul`` takes no [1] tensor)."""
    grads = [g.to(p.dtype) for p, g in zip(params, grads)]
    return {"ParamOut": torch._foreach_sub(params,
                                           torch._foreach_mul(grads, lr))}


@register_op("momentum", differentiable=False)
def _momentum(ctx, inputs, attrs):
    """momentum_op.cc: v = mu·v + g; p -= lr·v, or with Nesterov
    p -= (g + mu·v)·lr."""
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    (v,) = inputs["Velocity"]
    mu = attrs["mu"]
    lr = _lr(inputs)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


def momentum_list(params, grads, vels, lr, attrs):
    """`_momentum` over parameter lists; `lr` is a 0-dim tensor."""
    mu = attrs["mu"]
    v_out = torch._foreach_add(torch._foreach_mul(vels, mu), grads)
    if attrs.get("use_nesterov", False):
        step = torch._foreach_add(grads, torch._foreach_mul(v_out, mu))
        p_out = torch._foreach_sub(params, torch._foreach_mul(step, lr))
    else:
        p_out = torch._foreach_sub(params, torch._foreach_mul(v_out, lr))
    return {"ParamOut": p_out, "VelocityOut": v_out}


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
    if isinstance(g, SelectedRows):
        # adam_op.cc SelectedRows kernel (lazy mode): only touched rows
        # advance; duplicates are merged first (adam is nonlinear in g)
        (m,) = inputs["Moment1"]
        (v,) = inputs["Moment2"]
        b1 = attrs.get("beta1", 0.9)
        b2 = attrs.get("beta2", 0.999)
        ids, rows = g.merged()
        rows = rows.to(p.dtype)
        m_r = b1 * m[ids] + (1 - b1) * rows
        v_r = b2 * v[ids] + (1 - b2) * rows * rows
        p_r = p[ids] - lr_t * m_r / (torch.sqrt(v_r) + eps)
        return {
            "ParamOut": [p.index_copy(0, ids, p_r)],
            "Moment1Out": [m.index_copy(0, ids, m_r)],
            "Moment2Out": [v.index_copy(0, ids, v_r)],
            "Beta1PowOut": [b1p_out], "Beta2PowOut": [b2p_out],
        }
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


@register_op("adagrad", differentiable=False)
def _adagrad(ctx, inputs, attrs):
    """adagrad_op.cc: m += g², p -= lr·g/(√m + eps); a SelectedRows
    gradient is merged first (SparseAdagradFunctor) and advances only the
    touched rows. The square root is the correctly rounded one, as in
    ``adagrad_row_packed``, so a dense table and a packed one take the same
    steps bit for bit."""
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    (m,) = inputs["Moment"]
    eps = attrs.get("epsilon", 1e-6)
    lr = _lr(inputs)
    if isinstance(g, SelectedRows):
        ids, rows = g.merged()
        rows = rows.to(p.dtype)
        m_r = m[ids] + rows * rows
        p_r = p[ids] - lr * rows / (sqrt_rn(m_r) + eps)
        return {"ParamOut": [p.index_copy(0, ids, p_r)],
                "MomentOut": [m.index_copy(0, ids, m_r)]}
    m_out = m + g * g
    return {"ParamOut": [p - lr * g / (sqrt_rn(m_out) + eps)],
            "MomentOut": [m_out]}


@register_op("lars_momentum", differentiable=False)
def _lars_momentum(ctx, inputs, attrs):
    """lars_momentum_op.cc: layer-wise adaptive rate scaling. The two norms
    are sums over the parameter, whose order differs from XLA's, so the
    update agrees with the JAX op within a tolerance, not bit for bit."""
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    (v,) = inputs["Velocity"]
    mu = attrs["mu"]
    lars_coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    lr = _lr(inputs)
    p_norm = torch.sqrt(torch.sum(p * p))
    g_norm = torch.sqrt(torch.sum(g * g))
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * lars_coeff * p_norm / (g_norm + wd * p_norm + eps), lr)
    v_out = mu * v + local_lr * (g + wd * p)
    return {"ParamOut": [p - v_out], "VelocityOut": [v_out]}


@register_op("adamax", differentiable=False)
def _adamax(ctx, inputs, attrs):
    """adamax_op.cc; Beta1Pow advances in a separate scale op (the
    optimizer appends it)."""
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    (m,) = inputs["Moment"]
    (inf_norm,) = inputs["InfNorm"]
    (b1p,) = inputs["Beta1Pow"]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(inputs)
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf_norm, torch.abs(g))
    p_out = p - (lr / (1 - b1p.reshape(()))) * m_out / (inf_out + eps)
    return {"ParamOut": [p_out], "MomentOut": [m_out],
            "InfNormOut": [inf_out]}


@register_op("decayed_adagrad", differentiable=False)
def _decayed_adagrad(ctx, inputs, attrs):
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    (m,) = inputs["Moment"]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    lr = _lr(inputs)
    m_out = decay * m + (1 - decay) * g * g
    return {"ParamOut": [p - lr * g / (sqrt_rn(m_out) + eps)],
            "MomentOut": [m_out]}


@register_op("adadelta", differentiable=False)
def _adadelta(ctx, inputs, attrs):
    """adadelta_op.cc (the learning rate is not used)."""
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    (avg_sq_g,) = inputs["AvgSquaredGrad"]
    (avg_sq_u,) = inputs["AvgSquaredUpdate"]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g_out = rho * avg_sq_g + (1 - rho) * g * g
    update = -sqrt_rn((avg_sq_u + eps) / (g_out + eps)) * g
    u_out = rho * avg_sq_u + (1 - rho) * update * update
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [g_out],
            "AvgSquaredUpdateOut": [u_out]}


@register_op("rmsprop", differentiable=False)
def _rmsprop(ctx, inputs, attrs):
    """rmsprop_op.cc, centered or not (MeanGrad passes through when not)."""
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    (ms,) = inputs["MeanSquare"]
    (mg,) = inputs["MeanGrad"]
    (mom,) = inputs["Moment"]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    lr = _lr(inputs)
    ms_out = rho * ms + (1 - rho) * g * g
    if attrs.get("centered", False):
        mg_out = rho * mg + (1 - rho) * g
        denom = ms_out - mg_out * mg_out + eps
    else:
        mg_out = mg
        denom = ms_out + eps
    mom_out = momentum * mom + lr * g / sqrt_rn(denom)
    return {"ParamOut": [p - mom_out], "MeanSquareOut": [ms_out],
            "MeanGradOut": [mg_out], "MomentOut": [mom_out]}


def _pow_rn(x: torch.Tensor, e: float) -> torch.Tensor:
    """x ** e through float64, rounded once to x's dtype: the same on the
    CPU and the card (their float32 pow differ by an ulp or two, which
    ftrl's difference of two powers magnifies)."""
    return torch.pow(x.double(), e).to(x.dtype)


@register_op("ftrl", differentiable=False)
def _ftrl(ctx, inputs, attrs):
    """ftrl_op.cc: the square-root form at lr_power = -0.5, the general
    power (``_pow_rn``) otherwise."""
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    (sq,) = inputs["SquaredAccumulator"]
    (lin,) = inputs["LinearAccumulator"]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    lr = _lr(inputs)
    new_sq = sq + g * g
    if lr_power == -0.5:
        sigma = (sqrt_rn(new_sq) - sqrt_rn(sq)) / lr
    else:
        sigma = (_pow_rn(new_sq, -lr_power) - _pow_rn(sq, -lr_power)) / lr
    lin_out = lin + g - sigma * p
    if lr_power == -0.5:
        x = l2 + sqrt_rn(new_sq) / lr
    else:
        x = l2 + _pow_rn(new_sq, -lr_power) / lr
    pre = torch.clamp(lin_out, -l1, l1) - lin_out
    p_out = torch.where(torch.abs(lin_out) > l1, pre / x,
                        torch.zeros_like(p))
    return {"ParamOut": [p_out], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [lin_out]}


# -- DGC momentum --------------------------------------------------------------

_DGC_CONSTS = {}  # (values, dtype, device) -> a small device tensor


def _dgc_const(values, dtype, device):
    key = (tuple(values), dtype, str(device))
    t = _DGC_CONSTS.get(key)
    if t is None:
        t = _DGC_CONSTS[key] = torch.tensor(list(values), dtype=dtype,
                                            device=device)
    return t


def top_k_set(absflat: torch.Tensor, k: int) -> torch.Tensor:
    """The bool mask of ``lax.top_k(absflat, k)``'s index set: the k largest
    values, ties at the k-th value going to the lower indices.
    ``torch.topk`` gives the k-th value exactly but picks tied entries in
    no promised order, so the set is rebuilt from that value: every entry
    above it, then the first equal ones (a running count). No host
    read."""
    t = torch.topk(absflat, k).values[-1]
    gt = absflat > t
    eq = absflat == t
    need = k - gt.sum()
    return gt | (eq & (torch.cumsum(eq, 0) <= need))


def top_k_order(absflat: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k(absflat, k)``'s indices in its order: value descending,
    ties by the lower index. The set from `top_k_set`, compacted in index
    order by one scatter, then a stable sort of its k values."""
    n = absflat.shape[0]
    chosen = top_k_set(absflat, k)
    pos = torch.cumsum(chosen, 0) - 1
    buf = torch.empty(k + 1, dtype=torch.int64, device=absflat.device)
    buf.scatter_(0, torch.where(chosen, pos, k),
                 torch.arange(n, device=absflat.device))
    ci = buf[:k]
    order = torch.sort(absflat[ci], descending=True, stable=True).indices
    return ci[order]


@functools.lru_cache(maxsize=None)
def _dgc_keep_counts(sparsity, n, k):
    """How many of the k ranked candidates each stage keeps: the JAX
    function's ``rank < max(1, ratio·n)`` over ``arange(k)``, with the
    ratios and the product in float32 as it computes them (the ranks
    below 2^24 are exact in float32, so the count is the cut's
    ceiling)."""
    out = []
    for s in sparsity:
        cut = max(np.float32(1.0), np.float32(1.0 - s) * np.float32(n))
        out.append(min(k, math.ceil(float(cut))))
    return tuple(out)


@register_op("dgc_momentum", differentiable=False)
def _dgc_momentum(ctx, inputs, attrs):
    """DGC momentum (reference optimizer.py:799 math, the JAX package's
    ``dgc_momentum``): momentum-correct into the send buffer, top-k select
    with error feedback, sparse parameter update. Dense momentum until
    rampup_begin_step (bitwise the ``momentum`` op); sparsity then steps
    through attrs['sparsity'] over rampup_step steps. The candidates are
    the LOOSEST sparsity's k, ranked as ``lax.top_k`` ranks them; each
    stage keeps its leading ``max(1, ratio·n)``; after the rampup the
    final sparsity's k_final. The stage comes from the float ``Step``
    accumulator on the device: no host read.

    On a mesh the update needs the whole parameter (a top-k over a shard
    picks other entries): the mesh step runs every update op that is not
    elementwise on its inputs gathered whole and cuts its outputs back
    to the stored layout (``core/mesh_step.py``), so a ZeRO shard or a tp
    slice of Param, Grad, Velocity and Residual is made whole first."""
    (p,) = inputs["Param"]
    (g,) = inputs["Grad"]
    (v,) = inputs["Velocity"]
    (r,) = inputs["Residual"]
    (step,) = inputs["Step"]
    mu = attrs["mu"]
    lr = _lr(inputs)
    sparsity = list(attrs.get("sparsity", [0.999]))
    rampup_begin = attrs.get("rampup_begin_step", 0)
    rampup_step = max(1, attrs.get("rampup_step", 1))
    g = g.to(p.dtype)
    s = step.reshape(())
    dense_phase = s < rampup_begin

    # DGC local gradient clipping, sparse phase only (the dense rampup is
    # exactly plain momentum); clip_norm=0 disables
    clip = attrs.get("clip_norm", 1.0)
    if clip:
        gn = torch.sqrt(torch.sum(g.float() ** 2))
        factor = torch.clamp(clip / (gn + 1e-12), max=1.0)
        g = torch.where(dense_phase, g, (g * factor).to(p.dtype))

    # momentum correction: local momentum feeds the send buffer
    v_out = mu * v + g
    u = r + v_out
    flat = u.reshape(-1)
    n = flat.shape[0]
    k = max(1, int(n * (1.0 - min(sparsity))))
    k_final = max(1, int(n * (1.0 - sparsity[-1])))
    counts = _dgc_keep_counts(tuple(sparsity), n, k)
    per = max(1, rampup_step // max(1, len(sparsity)))
    absflat = flat.abs()
    if min(counts) >= k and k_final == k:
        # every stage keeps all k candidates: the set alone decides
        mask = top_k_set(absflat, k).to(p.dtype)
    else:
        stage = torch.clamp(torch.div(s - rampup_begin, per,
                                      rounding_mode="floor"),
                            0, len(sparsity) - 1).long()
        m = _dgc_const(counts, torch.int64, flat.device)[stage]
        if k_final != k:
            # after the rampup: the final sparsity's top k_final
            m = torch.where(s < rampup_begin + rampup_step, m,
                            torch.clamp(m, max=k_final))
        idx = top_k_order(absflat, k)
        keep = (torch.arange(k, device=flat.device) < m).to(p.dtype)
        mask = torch.zeros_like(flat).index_put_((idx,), keep)
    mask = torch.where(dense_phase, torch.ones_like(mask), mask)
    sparse = (flat * mask).reshape(p.shape)
    r_out = (flat * (1.0 - mask)).reshape(p.shape)

    # momentum factor masking: clear the velocity at the sent positions
    # (the dense phase keeps the full velocity)
    vel_keep = torch.where(dense_phase, torch.ones_like(mask), 1.0 - mask)
    v_out = (v_out.reshape(-1) * vel_keep).reshape(p.shape)

    if attrs.get("use_nesterov", False):
        # the dense phase is the momentum op's Nesterov, p − lr·(g + mu·v');
        # the sparse phase applies the selected mass only
        p_out = p - lr * torch.where(dense_phase, g + mu * v_out, sparse)
    else:
        p_out = p - lr * sparse
    return {"ParamOut": [p_out], "VelocityOut": [v_out],
            "ResidualOut": [r_out], "StepOut": [step + 1]}
