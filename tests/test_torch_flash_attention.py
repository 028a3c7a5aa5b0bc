"""paddle_tpu_torch flash attention, forward and backward, against the JAX
package.

The port's plain PyTorch versions are held against the JAX package's CPU
fallback (`_flash_fwd_jax` / `_flash_bwd_jax`, and the public entries) and
against the Pallas kernels run by the interpreter, as
tests/test_flash_attention.py runs them. f32 throughout: forward
rtol = atol = 2e-5, backward 2e-4 (the JAX backward test's own tolerance);
the two sum in different orders. Attention dropout draws Philox bits the
TPU kernels cannot reproduce, so it is checked by its known-answer vectors,
its keep rate, determinism per seed and gradients consistent with its mask,
never bit for bit against the JAX package. The hand-written CUDA kernels run
only on a card (the `cuda` tests and chip_smoke.py)."""
import ctypes
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import flash_attention_sparse as tfas
from paddle_tpu_torch.ops.kernels.tf32x3 import (mm_3xtf32, mm_3xtf32_groups,
                                                 rna_tf32, rz_f32, trunc_tf32)

jfa = importlib.import_module("paddle_tpu.ops.pallas_kernels.flash_attention")

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, scope and unique names of the port."""
    from paddle_tpu_torch.core import program as prog_mod
    from paddle_tpu_torch.core import scope as scope_mod
    from paddle_tpu_torch.core import unique_name

    old = (prog_mod._main_program, prog_mod._startup_program,
           scope_mod._global_scope, scope_mod._current_scope)
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    scope_mod._global_scope = scope_mod._current_scope = scope_mod.Scope()
    with unique_name.guard():
        yield
    (prog_mod._main_program, prog_mod._startup_program,
     scope_mod._global_scope, scope_mod._current_scope) = old


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _bias(kind, bh, t, seed=5):
    if kind is None:
        return None
    if kind == "row":   # the BERT-style [BH, 1, T] mask
        m = np.zeros((bh, 1, t), np.float32)
        m[:, :, 2 * t // 3:] = -1e4
        return m
    return _rand((bh, t, t), seed)   # a per-q [BH, T, T] bias


def _port_folded(q, k, v, bias, causal):
    """Run the port's plain version on folded [BH, T, d] numpy inputs (on
    copies: jnp.asarray may alias a numpy buffer the JAX side still uses)."""
    tq = lambda x: torch.tensor(x)[None]   # [1, BH, T, d]
    b = None if bias is None else torch.tensor(bias)[None]
    out, lse = tfa.flash_attention_fwd(tq(q), tq(k), tq(v), b, causal,
                                       1.0 / np.sqrt(q.shape[-1]))
    return out[0].numpy(), lse[0].numpy()


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("bias_kind", [None, "row", "full"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_interpret(t, bias_kind, causal):
    bh, d = 4, 64
    q, k, v = (_rand((bh, t, d), i) for i in range(3))
    bias = _bias(bias_kind, bh, t)
    want_out, want_lse = (np.asarray(x) for x in jfa._flash_fwd_pallas(
        jnp.array(q), jnp.array(k), jnp.array(v),
        None if bias is None else jnp.array(bias), 1.0 / np.sqrt(d),
        causal, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K, interpret=True))
    got_out, got_lse = _port_folded(q, k, v, bias, causal)
    np.testing.assert_allclose(got_out, want_out, **TOL)
    np.testing.assert_allclose(got_lse, want_lse, **TOL)


@pytest.mark.parametrize("bias_kind", [None, "row", "full"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_fallback_with_lse(bias_kind, causal):
    """Against the blocked two-pass JAX fallback, several K blocks deep."""
    bh, t, d = 3, 96, 32
    q, k, v = (_rand((bh, t, d), 10 + i) for i in range(3))
    bias = _bias(bias_kind, bh, t)
    want_out, want_lse = (np.asarray(x) for x in jfa._flash_fwd_jax(
        jnp.array(q), jnp.array(k), jnp.array(v),
        None if bias is None else jnp.array(bias), 1.0 / np.sqrt(d),
        causal, 32))
    got_out, got_lse = _port_folded(q, k, v, bias, causal)
    np.testing.assert_allclose(got_out, want_out, **TOL)
    np.testing.assert_allclose(got_lse, want_lse, **TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_packed_matches_jax_packed(with_mask):
    """The packed [B, T, nh·d] entry, q/k/v as views of one fused qkv."""
    b, t, nh, d = 2, 64, 2, 64
    qkv = _rand((b, t, 3 * nh * d), 3)
    mask = None
    if with_mask:
        mask = np.zeros((b, 1, t), np.float32)
        mask[0, :, 40:] = -1e4
        mask[1, :, 20:] = -1e4
    jq, jk, jv = jnp.split(jnp.array(qkv), 3, axis=-1)
    want = np.asarray(jfa.flash_attention_packed(
        jq, jk, jv, nh, bias=None if mask is None else jnp.array(mask)))
    tq, tk, tv = torch.tensor(qkv).split(nh * d, dim=-1)
    got = tfa.flash_attention_packed(
        tq, tk, tv, nh, bias=None if mask is None else torch.tensor(mask))
    assert got.shape == (b, t, nh * d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_4d_matches_jax_flash_attention(causal):
    b, h, t, d = 2, 3, 64, 16
    q, k, v = (_rand((b, h, t, d), 20 + i) for i in range(3))
    mask = np.where(np.random.RandomState(9).rand(b, 1, 1, t) > 0.3, 0.0,
                    -1e4).astype(np.float32)
    want = np.asarray(jfa.flash_attention(
        jnp.array(q), jnp.array(k), jnp.array(v), bias=jnp.array(mask),
        causal=causal))
    got = tfa.flash_attention(*(torch.tensor(x) for x in (q, k, v)),
                              bias=torch.tensor(mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ragged_t_and_fully_masked_rows():
    """A T with no power-of-two block divisor, and rows whose every score is
    -inf: the JAX semantics (m starts at -1e30, l == 0 divides by 1) give
    out = 0 and lse = -1e30 there."""
    b, h, t, d = 1, 2, 37, 8
    q, k, v = (torch.from_numpy(_rand((b, h, t, d), 30 + i))
               for i in range(3))
    bias = torch.zeros(b, h, t, t)
    bias[:, :, :5] = float("-inf")          # rows 0..4 see nothing
    out, lse = tfa.flash_attention_fwd(q, k, v, bias)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) / np.sqrt(d)
    ref = torch.softmax(s[:, :, 5:], -1) @ v.double()
    np.testing.assert_allclose(out[:, :, 5:].numpy(), ref.numpy(), **TOL)
    assert torch.all(out[:, :, :5] == 0)
    assert torch.all(lse[:, :, :5] == tfa.NEG_INF)


def test_bf16_plain_rounds_p_like_the_kernels():
    """bf16 in, bf16 out, f32 lse; within bf16 rounding of the f32 result."""
    b, h, t, d = 2, 2, 32, 64
    q, k, v = (torch.from_numpy(_rand((b, h, t, d), 40 + i))
               for i in range(3))
    out32, lse32 = tfa.flash_attention_fwd(q, k, v)
    out16, lse16 = tfa.flash_attention_fwd(q.bfloat16(), k.bfloat16(),
                                           v.bfloat16())
    assert out16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lse16.numpy(), lse32.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_wrapper_checks_and_counts_only_kernel_launches():
    q = torch.zeros(1, 2, 8, 16)
    before = tfa.flash_attention_fwd.launches
    tfa.flash_attention_fwd(q, q, q)     # CPU: the plain version, no launch
    assert tfa.flash_attention_fwd.launches == before
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention_fwd(q, q.double(), q)
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_attention_fwd(q, torch.zeros(1, 2, 8, 32), q)
    with pytest.raises(ValueError, match=r"\[B, 1, T\]"):
        tfa.flash_attention_packed(torch.zeros(1, 8, 32), torch.zeros(1, 8, 32),
                                   torch.zeros(1, 8, 32), 2,
                                   bias=torch.zeros(1, 8, 8))


def test_dropout_in_training_runs_in_the_op():
    """The op draws one seed per call from the run's generator when training
    with dropout, so two contexts with equal generators agree and the
    output differs from no dropout; at test time it serves undropped."""
    from paddle_tpu_torch.core.executor import ExecContext
    from paddle_tpu_torch.core.registry import get_op

    x = torch.from_numpy(_rand((2, 8, 128), 50))
    fn = get_op("flash_attention").fn
    attrs = {"dropout_prob": 0.1, "is_test": False, "num_heads": 2}
    ins = {"Q": [x], "K": [x * 0.5], "V": [x]}

    def run(ctx):
        return fn(ctx, ins, attrs)["Out"][0]

    a = run(ExecContext("cpu", torch.Generator().manual_seed(3)))
    b = run(ExecContext("cpu", torch.Generator().manual_seed(3)))
    c = run(ExecContext("cpu", torch.Generator().manual_seed(4)))
    ref = run(ExecContext("cpu", is_test=True))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, ref)
    assert ref.shape == x.shape
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tfa.flash_attention_packed(x, x, x, 2, dropout_rate=1.0)


def test_philox_known_answers():
    """Philox-4x32-10 known-answer vectors (Random123 kat_vectors)."""
    t = lambda *w: [torch.tensor(x, dtype=torch.int64) for x in w]
    for ctr, key, want in (
            ((0, 0, 0, 0), (0, 0),
             (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
            ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
            ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
             (0xA4093822, 0x299F31D0),
             (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))):
        got = tfa.philox4x32(*t(*ctr), *key)
        assert [int(w) for w in got] == list(want)


def test_dropout_mask_is_seeded_and_keeps_the_rate():
    b, nh, t = 2, 3, 96
    m1 = tfa.dropout_keep_mask(7, 0.1, b, nh, t, t)
    assert m1.shape == (b, nh, t, t) and m1.dtype == torch.bool
    assert torch.equal(m1, tfa.dropout_keep_mask(torch.tensor([7]), 0.1, b,
                                                 nh, t, t))
    assert not torch.equal(m1, tfa.dropout_keep_mask(8, 0.1, b, nh, t, t))
    n = m1.numel()
    rate = m1.float().mean().item()
    assert abs(rate - 0.9) < 5 * np.sqrt(0.9 * 0.1 / n)
    # a pure function of (seed, bh, i, j): a bigger tile sees the same bits
    big = tfa.dropout_keep_mask(7, 0.1, b, nh, t + 5, t + 7)
    assert torch.equal(big[..., :t, :t], m1)
    # the threshold rule: drop iff the word < round(rate * 2^32)
    assert tfa.dropout_threshold(0.1) == 429496730
    assert tfa.dropout_keep_mask(7, 0.0, 1, 1, 4, 4).all()


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_grads_follow_the_mask(causal):
    """Forward and backward with dropout equal dense attention with the
    same keep mask applied to the normalized probabilities."""
    b, nh, t, d, rate, seed = 1, 2, 40, 16, 0.25, 1234
    q, k, v = (torch.from_numpy(_rand((b, nh, t, d), 60 + i))
               .requires_grad_() for i in range(3))
    bias = torch.from_numpy(_rand((b, 1, 1, t), 63)).requires_grad_()
    out = tfa.flash_attention(q, k, v, bias, causal, dropout_rate=rate,
                              seed=seed)
    g = torch.from_numpy(_rand((b, nh, t, d), 64))
    got = torch.autograd.grad(out, (q, k, v, bias), g)

    qq, kk, vv, bb = (x.detach().double().requires_grad_()
                      for x in (q, k, v, bias))
    s = qq @ kk.transpose(-1, -2) / np.sqrt(d) + bb
    if causal:
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(),
                          tfa.NEG_INF)
    keep = tfa.dropout_keep_mask(seed, rate, b, nh, t, t)
    p = torch.where(keep, torch.softmax(s, -1) / (1 - rate),
                    torch.zeros_like(s))
    ref_out = p @ vv
    want = torch.autograd.grad(ref_out, (qq, kk, vv, bb), g.double())
    np.testing.assert_allclose(out.detach().numpy(), ref_out.detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), w.numpy(), **BWD_TOL)


def _port_bwd_folded(q, k, v, bias, causal, g, dbias):
    tq = lambda x: torch.tensor(x)[None]   # [1, BH, T, d]
    b = None if bias is None else torch.tensor(bias)[None]
    sm = 1.0 / np.sqrt(q.shape[-1])
    out, lse = tfa.flash_attention_fwd(tq(q), tq(k), tq(v), b, causal, sm)
    res = tfa.flash_attention_bwd(tq(q), tq(k), tq(v), out, lse, tq(g), b,
                                  causal, sm, dbias=dbias)
    return [None if r is None else r[0].numpy() for r in res]


@pytest.mark.parametrize("bias_kind", [None, "row", "full"])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_jax_fallback(bias_kind, causal):
    """Against `_flash_bwd_jax`, several K blocks deep: dq, dk, dv and dbias
    (ds per query for a full bias; its column sum for the row mask)."""
    bh, t, d = 3, 96, 32
    q, k, v, g = (_rand((bh, t, d), 70 + i) for i in range(4))
    bias = _bias(bias_kind, bh, t)
    sm = 1.0 / np.sqrt(d)
    jb = None if bias is None else jnp.array(bias)
    out, lse = jfa._flash_fwd_jax(jnp.array(q), jnp.array(k), jnp.array(v),
                                  jb, sm, causal, 32)
    want = [None if x is None else np.asarray(x) for x in jfa._flash_bwd_jax(
        (jnp.array(q), jnp.array(k), jnp.array(v), jb, None, out, lse),
        jnp.array(g), sm_scale=sm, causal=causal, block_k=32,
        dropout_rate=0.0, has_bias=bias is not None)]
    form = {None: None, "row": "col", "full": "per_q"}[bias_kind]
    got = _port_bwd_folded(q, k, v, bias, causal, g, form)
    for a, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, w, **BWD_TOL)
    if bias_kind == "full":
        np.testing.assert_allclose(got[3], want[3], **BWD_TOL)
    elif bias_kind == "row":
        np.testing.assert_allclose(got[3], want[3].sum(1), **BWD_TOL)
    else:
        assert got[3] is None


@pytest.mark.parametrize("causal,bias_kind", [
    (False, "none"), (True, "none"), (False, "mask"), (True, "mask"),
    (False, "full"), (True, "full")])
@pytest.mark.parametrize("force_general", [False, True])
def test_bwd_matches_pallas_interpret(causal, bias_kind, force_general,
                                      monkeypatch):
    """jax.grad through the Pallas kernels in interpret mode (the one-pass
    grouped kernel, or with _pick_group pinned to 1 the general dq and dk/dv
    kernels incl. the column-sum dbias), as tests/test_flash_attention.py
    runs them, against torch.autograd through the port's flash_attention:
    dq, dk, dv and dbias (per query for a full bias, the column-sum form for
    the [B,1,1,T] mask)."""
    import jax

    if force_general:
        monkeypatch.setattr(jfa, "_pick_group", lambda *a, **k: 1)
    monkeypatch.setattr(jfa, "FORCE_PALLAS_INTERPRET", True)
    b, h, t, d = 1, 2, 128, 64
    q, k, v = (_rand((b, h, t, d), 80 + i) for i in range(3))
    bias = None
    if bias_kind == "mask":
        bias = np.where(np.random.RandomState(9).rand(b, 1, 1, t) > 0.3,
                        0.0, -1e4).astype(np.float32)
    elif bias_kind == "full":
        bias = 0.1 * _rand((b, h, t, t), 87)
    assert jfa._pallas_ok(t, d)

    def jloss(*args):
        bb = args[3] if len(args) > 3 else None
        return jnp.sum(jfa.flash_attention(*args[:3], bias=bb,
                                           causal=causal) ** 2)

    args = [jnp.array(x) for x in (q, k, v)] + (
        [] if bias is None else [jnp.array(bias)])
    want = jax.grad(jloss, tuple(range(len(args))))(*args)
    targs = [torch.from_numpy(x.copy()).requires_grad_()
             for x in (q, k, v) + (() if bias is None else (bias,))]
    out = tfa.flash_attention(*targs[:3],
                              bias=targs[3] if len(targs) > 3 else None,
                              causal=causal)
    got = torch.autograd.grad((out ** 2).sum(), targs)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **BWD_TOL)


def test_gpu_request_without_cuda_raises(tmp_path):
    """Entry points run on the card unless the caller asks for the CPU; with
    no card a GPU request is an error, never a quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the GPU request is served")
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference

    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.Executor(fluid.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="disable_gpu"):
        inference.create_predictor(inference.Config(str(tmp_path)))
    assert fluid.Executor(fluid.CPUPlace()).device.type == "cpu"


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no "
                    "CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,per_q,t,d", [
    (False, False, 128, 64), (True, False, 200, 64), (False, True, 100, 64),
    (True, True, 130, 128), (False, False, 64, 64), (False, False, 256, 64),
    (False, False, 130, 64), (False, True, 128, 192), (True, False, 130, 256),
    (False, False, 512, 64), (False, True, 512, 64), (False, False, 512, 256),
    (False, True, 128, 256)])
def test_cuda_kernel_matches_plain(dtype, tol, causal, per_q, t, d):
    _cuda_or_skip()
    g = torch.Generator("cuda").manual_seed(0)
    b, nh = 2, 3
    qkv = torch.randn(b, t, 3 * nh * d, generator=g, device="cuda").to(dtype)
    q, k, v = (x.unflatten(-1, (nh, d)).transpose(1, 2)
               for x in qkv.split(nh * d, dim=-1))
    if per_q:
        bias = torch.randn(b, nh, t, t, generator=g, device="cuda").to(dtype)
    else:
        bias = torch.zeros(b, 1, 1, t, device="cuda", dtype=dtype)
        bias[..., 3 * t // 4:] = -1e4
    before = tfa.flash_attention_fwd.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, bias, causal)
    assert tfa.flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, bias, causal)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("causal,bias_kind,t,d,rate", [
    (False, "mask", 128, 64, 0.0), (False, "mask", 128, 64, 0.1),
    (True, None, 200, 64, 0.0), (False, "perq", 100, 64, 0.0),
    (True, "perq", 130, 128, 0.2), (False, "mask", 64, 64, 0.0),
    (False, "mask", 256, 64, 0.1), (False, "mask", 130, 64, 0.0),
    (True, None, 128, 128, 0.2), (False, "mask", 128, 192, 0.1),
    (True, "perq", 130, 256, 0.0)])
def test_cuda_bwd_kernel_matches_plain(dtype, tol, causal, bias_kind, t, d,
                                       rate):
    """The backward kernels against their plain version on the card, dbias
    included, with the same dropout seed; max |err| <= tol · max |plain|."""
    _cuda_or_skip()
    g = torch.Generator("cuda").manual_seed(1)
    b, nh = 2, 3
    qkv = torch.randn(b, t, 3 * nh * d, generator=g, device="cuda").to(dtype)
    q, k, v = (x.unflatten(-1, (nh, d)).transpose(1, 2)
               for x in qkv.split(nh * d, dim=-1))
    bias, form = None, None
    if bias_kind == "perq":
        bias = torch.randn(b, nh, t, t, generator=g, device="cuda").to(dtype)
        form = "per_q"
    elif bias_kind == "mask":
        bias = torch.zeros(b, 1, 1, t, device="cuda", dtype=dtype)
        bias[..., 3 * t // 4:] = -1e4
        form = "col"
    out, lse = tfa.flash_attention_fwd(q, k, v, bias, causal, None, rate, 5)
    dout = torch.randn(b, nh, t, d, generator=g, device="cuda").to(dtype)
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, bias, causal, None,
                                  rate, 5, form)
    assert tfa.flash_attention_bwd.launches == before + 1
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, dout, bias,
                                         causal, None, rate, 5, form)
    for a, w in zip(got, want):
        if w is None:
            assert a is None
            continue
        err = (a.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item(), err


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 192, 256, 320, 384, 512,
                               1024])
def test_flash_route_mirrors_pallas_ok(d, device_type, monkeypatch):
    """The port's static route: a CPU tensor takes the plain version; on the
    card d % 64 != 0 takes it too (the JAX package's XLA path) and every
    multiple of 64 a kernel: d = 64, 128, 192 and 256 the tuned family,
    d = 320 and up the wide kernels (HEAD_DIMS says which)."""
    shape = (2, 3, 128, d)
    want = "plain" if device_type == "cpu" or d % 64 else "kernel"
    for dtype in (torch.float32, torch.bfloat16):
        assert tfa.flash_route(shape, dtype, device_type) == want
    # the card's choice is _pallas_ok's head-dim rule (Pallas forced on)
    monkeypatch.setattr(jfa, "FORCE_PALLAS_INTERPRET", True)
    assert jfa._pallas_ok(128, d) == (d % 64 == 0)


@pytest.mark.parametrize("entry", ["packed", "4d"])
@pytest.mark.parametrize("t", [100, 36, 200])
def test_no_block_divisor_raises_as_jax(entry, t):
    """The public entries raise where JAX's do (_flash_fwd_dispatch): a
    sequence length with no power-of-two block divisor ≥ 8 (T = 100, 36),
    before any launch; T = 200 (block 8) computes in both packages. The
    wrappers below the entries keep taking any T."""
    b, nh, d = 2, 2, 8
    x = _rand((b, t, nh * d), 30) if entry == "packed" else \
        _rand((b, nh, t, d), 30)
    if entry == "packed":
        jcall = lambda: jfa.flash_attention_packed(*[jnp.array(x)] * 3, nh)
        tcall = lambda: tfa.flash_attention_packed(*[torch.tensor(x)] * 3,
                                                   nh)
    else:
        jcall = lambda: jfa.flash_attention(*[jnp.array(x)] * 3)
        tcall = lambda: tfa.flash_attention(*[torch.tensor(x)] * 3)
    if t % 8:
        msg = r"seq len %d has no power-of-two block divisor" % t
        with pytest.raises(ValueError, match=msg):
            jcall()
        with pytest.raises(ValueError, match=msg):
            tcall()
        assert tfa.pick_block(t) is None
    else:
        np.testing.assert_allclose(tcall().numpy(), np.asarray(jcall()),
                                   **TOL)
        assert tfa.pick_block(t) == jfa._pick_blocks(t)[0]


@pytest.mark.parametrize("d", [192, 256, 320, 512])
def test_wide_head_dims_match_pallas_interpret(d, monkeypatch):
    """d = 192 to 512 go to the kernels on the card (the tuned family up to
    256, the wide kernels above), as JAX sends them to Pallas: the port's
    op against jax.grad through the Pallas kernels in
    interpret mode, f32, at T = 64 with the [B,1,1,T] mask: out (TOL) and
    dq, dk, dv (BWD_TOL)."""
    import jax

    monkeypatch.setattr(jfa, "FORCE_PALLAS_INTERPRET", True)
    b, h, t = 1, 2, 64
    assert jfa._pallas_ok(t, d)
    q, k, v = (_rand((b, h, t, d), 40 + i, 0.5) for i in range(3))
    mask = np.where(np.random.RandomState(7).rand(b, 1, 1, t) > 0.25, 0.0,
                    -1e4).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, bias=jnp.array(mask))
                       ** 2)

    jargs = [jnp.array(x) for x in (q, k, v)]
    want_out = np.asarray(jfa.flash_attention(*jargs, bias=jnp.array(mask)))
    want = jax.grad(jloss, (0, 1, 2))(*jargs)
    targs = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*targs, bias=torch.from_numpy(mask))
    got = torch.autograd.grad((out ** 2).sum(), targs)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **BWD_TOL)


def test_flash_route_rejects_other_dtypes_and_devices():
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_route((1, 1, 8, 64), torch.float16, "cuda")
    with pytest.raises(ValueError, match="device type"):
        tfa.flash_route((1, 1, 8, 64), torch.float32, "meta")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 96])
def test_head_dims_without_kernel_match_jax(d, causal, monkeypatch):
    """At d = 32 and 96 the JAX op takes its blockwise XLA path; the port's
    op the plain version (on the card too): out, dq, dk and dv agree with
    jax.grad through jfa.flash_attention (f32, BWD_TOL), the [B,1,1,T] mask
    included."""
    import jax

    monkeypatch.setattr(jfa, "FORCE_PALLAS_INTERPRET", True)
    b, h, t = 2, 2, 64
    assert not jfa._pallas_ok(t, d)
    q, k, v = (_rand((b, h, t, d), 90 + i) for i in range(3))
    mask = np.where(np.random.RandomState(4).rand(b, 1, 1, t) > 0.25, 0.0,
                    -1e4).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, bias=jnp.array(mask),
                                           causal=causal) ** 2)

    jargs = [jnp.array(x) for x in (q, k, v)]
    want_out = np.asarray(jfa.flash_attention(*jargs, bias=jnp.array(mask),
                                              causal=causal))
    want = jax.grad(jloss, (0, 1, 2))(*jargs)
    targs = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*targs, bias=torch.from_numpy(mask),
                              causal=causal)
    got = torch.autograd.grad((out ** 2).sum(), targs)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **BWD_TOL)


def test_op_at_head_dim_32_runs_the_plain_version():
    """The flash_attention op of a BERT with hidden 384 and 12 heads (d=32):
    no kernel launch, and on the CPU no plain-on-card count."""
    from paddle_tpu_torch.core.executor import ExecContext
    from paddle_tpu_torch.core.registry import get_op

    x = torch.from_numpy(_rand((2, 16, 384), 95))
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_fwd.plain_on_cuda)
    out = get_op("flash_attention").fn(
        ExecContext("cpu", is_test=True), {"Q": [x], "K": [x], "V": [x]},
        {"num_heads": 12})["Out"][0]
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_fwd.plain_on_cuda) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_delta_plain_matches_bwd_host_prep(dtype):
    """delta = Σ_d dO·out, against the JAX package's _bwd_host_prep (its
    lane-replicated delta), from f32 or bf16 out and dO."""
    bh, t, d = 3, 40, 64
    out, g, q = (_rand((bh, t, d), 100 + i) for i in range(3))
    lse = _rand((bh, t), 103)
    out_t, g_t = (torch.from_numpy(x).to(dtype) for x in (out, g))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, _, delta_r = jfa._bwd_host_prep(
        jnp.array(q).astype(jdt), jnp.array(out_t.float().numpy()).astype(jdt),
        jnp.array(lse), jnp.array(g_t.float().numpy()).astype(jdt))
    want = np.asarray(delta_r)[..., 0]
    got = tfa.flash_attention_delta_plain(out_t[None], g_t[None])[0]
    assert got.dtype == torch.float32 and got.shape == (bh, t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the CPU entry of the delta kernel is its plain version
    torch.testing.assert_close(tfa.flash_attention_delta(out_t[None],
                                                         g_t[None])[0], got)


def test_delta_route_f32_cpu_and_dtypes_without_kernel():
    """flash_attention_delta, the f32 backward's delta kernel since the f32
    redesign: on a CPU f32 tensor it is the plain delta, which is
    _bwd_host_prep's; a dtype with no kernel raises on either device, and a
    device with no kernel raises."""
    bh, t, d = 2, 24, 64
    out, g, q = (_rand((bh, t, d), 110 + i) for i in range(3))
    _, _, delta_r = jfa._bwd_host_prep(jnp.array(q), jnp.array(out),
                                       jnp.array(_rand((bh, t), 113)),
                                       jnp.array(g))
    got = tfa.flash_attention_delta(torch.from_numpy(out)[None],
                                    torch.from_numpy(g)[None])[0]
    torch.testing.assert_close(got, tfa.flash_attention_delta_plain(
        torch.from_numpy(out), torch.from_numpy(g)), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(delta_r)[..., 0],
                               rtol=1e-5, atol=1e-5)
    half = torch.from_numpy(out)[None].half()
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention_delta(half, half)
    meta = torch.empty((1, bh, t, d), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_delta(meta, meta)


def _scores_16(a, b):
    """S or dP as the tuned f32 kernels form them: 16-column partial sums
    over the head dim, in order."""
    return mm_3xtf32(a, b, 16)


def _bwd_3xtf32(q, k, v, out, lse, g, bias, sm, causal=False, rate=0.0,
                seed=0, scores=_scores_16):
    """flash_attention_bwd_plain (f32) with each of its five products (s,
    dp, dv, dk, dq) in 3xTF32; s and dp as `scores` sums them (the tuned
    kernels: 16-column partial sums, the kernels' kPartialDepth; the wide
    ones: mm_3xtf32_groups), the outputs in one partial sum a 64-row tile.
    exp is exact here (the kernels use ex2.approx)."""
    kt = lambda x: x.transpose(-1, -2)
    s = scores(q, kt(k)) * sm
    if bias is not None:
        s = s + bias
    if causal:
        tq, tk = s.shape[-2:]
        s = s.masked_fill(~torch.ones(tq, tk, dtype=torch.bool).tril(),
                          tfa.NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = scores(g, kt(v))
    p_d = p
    if rate > 0.0:
        keep = tfa.dropout_keep_mask(seed, rate, *p.shape)
        p_d, dp = tfa._dropped(p, keep, rate), tfa._dropped(dp, keep, rate)
    dv = mm_3xtf32(kt(p_d), g, 64)
    ds = p * (dp - tfa.flash_attention_delta_plain(out, g)[..., None])
    return (mm_3xtf32(ds, k, 64) * sm, mm_3xtf32(kt(ds), q, 64) * sm, dv,
            ds)


def test_rna_tf32_rounds_like_cvt_rna():
    """Known answers of the TF32 rounding: 10 mantissa bits kept, ties away
    from zero for either sign; a TF32 value is kept as it is."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0 ** -23, 1.0 + 3 * one_ulp,
                      3.0e-3], dtype=torch.float32)
    got = rna_tf32(x)
    want = [1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + 3 * one_ulp]
    assert got[:4].tolist() == want
    assert abs(got[4].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    assert torch.equal(rna_tf32(got), got)
    # big + small, as the tensor core reads small, carries x to within
    # 2^-21 of its magnitude; cleared low bits read as truncation
    y = torch.from_numpy(_rand((4096,), 120))
    big = rna_tf32(y)
    rest = (y - big - trunc_tf32(y - big)).abs()
    assert bool((rest <= y.abs() * 2.0 ** -21).all())
    assert trunc_tf32(x)[:4].tolist() == [1.0, -1.0, 1.0, 1.0 + 3 * one_ulp]
    # rounding toward zero: one ulp below the nearest for 1 + 2^-24 + ...
    z = torch.tensor([1.0 + 2.0 ** -23 * 0.75, -(1.0 + 2.0 ** -23 * 0.75)],
                     dtype=torch.float64)
    assert rz_f32(z).tolist() == [1.0, -1.0]


@pytest.mark.parametrize(
    "t,d,per_q_bias,causal,rate",
    [(t, d, bias, False, 0.0) for t in (128, 512) for d in (64, 256)
     for bias in (False, True)]
    # chip_smoke's d = 128 causal edge cases
    + [(130, 128, True, True, 0.1), (128, 128, False, True, 0.2),
       (128, 128, True, True, 0.0)])
def test_3xtf32_products_hold_the_f32_backward(t, d, per_q_bias, causal,
                                               rate):
    """The decision rule of the f32 backward's 3xTF32 design: with its five
    products emulated as the kernels split and sum them (the tensor core's
    round-toward-zero sums included), dq, dk, dv (and the per-query dbias,
    ds itself) stay within a quarter of the card's f32 tolerance
    (chip_smoke BWD_TOL 2e-5, rtol = atol) of the plain f32 backward, at
    B=1, nh=2, the main path's T and the d = 128 causal edge cases (with
    dropout)."""
    tol = 2e-5 / 4
    q, k, v, g = (torch.from_numpy(_rand((1, 2, t, d), 130 + i))
                  for i in range(4))
    bias = (torch.from_numpy(_rand((1, 2, t, t), 134)) if per_q_bias
            else None)
    sm = 1.0 / np.sqrt(d)
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, bias, causal, sm, rate,
                                             5)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, bias, causal,
                                         sm, rate, 5, dbias="per_q")
    got = _bwd_3xtf32(q, k, v, out, lse, g, bias, sm, causal, rate, 5)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        torch.testing.assert_close(a, w, rtol=tol, atol=tol, msg=name)


def _fwd_3xtf32(q, k, v, bias, sm, causal=False, rate=0.0, seed=0,
                scores=_scores_16):
    """flash_attention_fwd_plain (f32) as the f32 forward kernels compute
    it: S = Q·Kᵀ in 3xTF32 summed as `scores` sums it (the backward's split
    and order), the online softmax over 64-key tiles, each tile's P·V in
    3xTF32 into a zeroed partial sum added to the rescaled O, and O / l at
    the end. exp is exact here (the kernels use ex2.approx)."""
    s = scores(q, k.transpose(-1, -2)) * sm
    if bias is not None:
        s = s + bias
    tq, tk = s.shape[-2:]
    if causal:
        s = s.masked_fill(~torch.ones(tq, tk, dtype=torch.bool).tril(),
                          tfa.NEG_INF)
    keep = (tfa.dropout_keep_mask(seed, rate, *s.shape) if rate > 0.0
            else None)
    m = torch.full(s.shape[:-1] + (1,), tfa.NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros(s.shape[:-1] + v.shape[-1:])
    for k0 in range(0, tk, 64):
        st = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        if keep is not None:
            p = tfa._dropped(p, keep[..., k0:k0 + 64], rate)
        o = o * corr + mm_3xtf32(p, v[..., k0:k0 + 64, :])
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return o * (1.0 / l_safe), (m + torch.log(l_safe)).squeeze(-1)


@pytest.mark.parametrize(
    "t,d,bias_kind,causal,rate",
    [(t, d, bias, False, 0.0) for t in (128, 512) for d in (64, 256)
     for bias in (None, "mask", "per_q")]
    # chip_smoke's d = 128 causal edge cases
    + [(130, 128, "per_q", True, 0.0), (130, 128, None, True, 0.2),
       (130, 128, "per_q", True, 0.1)])
def test_3xtf32_products_hold_the_f32_forward(t, d, bias_kind, causal, rate):
    """The decision rule of the f32 forward's 3xTF32 design: with its two
    products emulated as the kernel splits and sums them (the tensor core's
    round-toward-zero sums, S's 16-column partial sums and a key tile's P·V
    partial sum included), out and lse stay within a quarter of the card's
    f32 tolerance (chip_smoke TOL 2e-5, rtol = atol) of the plain f32
    forward, at B=1, nh=2, the main path's T, d = 64 and 256, with no bias,
    the [B,1,1,T] mask or a per-query bias, and at the d = 128 causal edge
    cases (with dropout)."""
    tol = 2e-5 / 4
    q, k, v = (torch.from_numpy(_rand((1, 2, t, d), 140 + i))
               for i in range(3))
    if bias_kind == "mask":
        bias = torch.zeros(1, 1, 1, t)
        bias[..., 3 * t // 4:] = -1e4
    elif bias_kind == "per_q":
        bias = torch.from_numpy(_rand((1, 2, t, t), 143))
    else:
        bias = None
    sm = 1.0 / np.sqrt(d)
    want = tfa.flash_attention_fwd_plain(q, k, v, bias, causal, sm, rate, 7)
    got = _fwd_3xtf32(q, k, v, bias, sm, causal, rate, 7)
    for name, a, w in zip(("out", "lse"), got, want):
        torch.testing.assert_close(a, w, rtol=tol, atol=tol, msg=name)


def test_3xtf32_pairs_sum_closer_to_exact_than_16_column_partials():
    """The f32 wide kernels' S and dP sums (mm_3xtf32_groups: 8-deep mma
    chains from zero, added in pairs) against the same four groups summed in
    16-column partial sums (the tuned kernels' depth), on 512-deep products
    of randn rows: the mean error against the exact product is smaller."""
    a = torch.from_numpy(_rand((2, 64, 512), 160))
    b = torch.from_numpy(_rand((2, 512, 64), 161))
    exact = a.double() @ b.double()
    idx = [torch.tensor([c for j in range(q, 8, 4)
                         for c in range(64 * j, 64 * j + 64)])
           for q in range(4)]
    g16 = [mm_3xtf32(a[..., i], b[..., i, :], 16) for i in idx]
    partial16 = ((g16[0] + g16[1]) + g16[2]) + g16[3]
    err = lambda x: float((x.double() - exact).abs().mean())
    assert err(mm_3xtf32_groups(a, b)) < err(partial16)


def _wide_case(case, d, t=128):
    """B=1, nh=2 inputs of the wide kernels' CPU model at head dim d: the
    [B,1,1,T] mask with dropout 0.1 (column-sum dbias), or a per-query bias,
    causal (per-query dbias)."""
    q, k, v, g = (torch.from_numpy(_rand((1, 2, t, d), 150 + i))
                  for i in range(4))
    if case == "mask_dropout":
        bias = torch.zeros(1, 1, 1, t)
        bias[..., 3 * t // 4:] = -1e4
        return q, k, v, g, bias, False, 0.1, "col"
    bias = torch.from_numpy(_rand((1, 2, t, t), 154))
    return q, k, v, g, bias, True, 0.0, "per_q"


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("case", ["mask_dropout", "per_q_causal"])
def test_3xtf32_wide_products_hold_the_f32_forward(case, d):
    """The decision rule of the f32 wide forward (d >= 320): S summed as its
    column warps sum it (mm_3xtf32_groups: 64-column blocks in four groups,
    8-column mma chains added in pairs, the groups added in one order), the
    online
    softmax and each key tile's P·V partial sum, emulated with the tensor
    core's round-toward-zero sums: out and lse within a quarter of the
    card's f32 tolerance (2e-5) of the plain f32 forward, at B=1, nh=2,
    T=128."""
    tol = 2e-5 / 4
    q, k, v, _, bias, causal, rate, _ = _wide_case(case, d)
    sm = 1.0 / np.sqrt(d)
    want = tfa.flash_attention_fwd_plain(q, k, v, bias, causal, sm, rate, 7)
    got = _fwd_3xtf32(q, k, v, bias, sm, causal, rate, 7,
                      scores=mm_3xtf32_groups)
    for name, a, w in zip(("out", "lse"), got, want):
        torch.testing.assert_close(a, w, rtol=tol, atol=tol, msg=name)


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("case", ["mask_dropout", "per_q_causal"])
def test_3xtf32_wide_products_hold_the_f32_backward(case, d):
    """The decision rule of the f32 wide backward: S and dP summed as the
    forward sums S (mm_3xtf32_groups), dq, dk and dv each in one partial sum
    a 64-row tile, in 3xTF32 with the tensor core's round-toward-zero sums:
    dq, dk, dv and the dbias of the case's form within a quarter of the
    card's f32 tolerance (2e-5) of the plain f32 backward. (The per-query
    dbias, ds itself, is where dP − delta cancels: in the tuned kernels'
    16-column order, _scores_16, it misses a quarter at d = 320 here.)"""
    tol = 2e-5 / 4
    q, k, v, g, bias, causal, rate, form = _wide_case(case, d)
    sm = 1.0 / np.sqrt(d)
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, bias, causal, sm, rate,
                                             5)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, bias, causal,
                                         sm, rate, 5, dbias=form)
    got = list(_bwd_3xtf32(q, k, v, out, lse, g, bias, sm, causal, rate, 5,
                           scores=mm_3xtf32_groups))
    if form == "col":
        got[3] = got[3].sum(-2, keepdim=True)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        torch.testing.assert_close(a, w.reshape(a.shape), rtol=tol, atol=tol,
                                   msg=name)


@pytest.mark.parametrize("case", ["mask_dropout", "per_q_causal"])
def test_ds_f64_is_the_plain_per_query_dbias(case):
    """flash_attention_ds_f64, the card's reference for an f32 per-query
    dbias, is the plain backward's ds (its per-query dbias) in f64: at
    d = 64, where the plain version's f32 dp does not cancel past the f32
    tolerance, the two agree within 1e-5, dropout's keep mask included; and
    given an f64 forward's out and lse it is the f64 autograd gradient of
    Σ out·g with respect to the bias, within 1e-9."""
    t = 40
    q, k, v, g, bias, causal, rate, _ = _wide_case(case, 64, t=t)
    bias = bias.expand(1, 2, t, t).contiguous()
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, bias, causal, None,
                                             rate, 3)
    ds = tfa.flash_attention_ds_f64(q, k, v, out, lse, g, bias, causal, None,
                                    rate, 3)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, bias, causal,
                                         None, rate, 3, "per_q")[3]
    assert ds.dtype == torch.float64
    torch.testing.assert_close(ds.float(), want, rtol=1e-5, atol=1e-5)
    q64, k64, v64, g64 = (x.double() for x in (q, k, v, g))
    b64 = bias.double().requires_grad_()
    s = q64 @ k64.transpose(-1, -2) / 8.0 + b64
    if causal:
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(),
                          tfa.NEG_INF)
    p = torch.softmax(s, -1)
    if rate > 0.0:
        keep = tfa.dropout_keep_mask(3, rate, 1, 2, t, t)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    o64 = p @ v64
    (grad,) = torch.autograd.grad((o64 * g64).sum(), b64)
    exact = tfa.flash_attention_ds_f64(q, k, v, o64.detach(),
                                       torch.logsumexp(s, -1).detach(), g,
                                       bias, causal, None, rate, 3)
    torch.testing.assert_close(exact, grad, rtol=1e-9, atol=1e-9)


def test_tma_desc_of_fused_qkv_views_and_broadcast_dims():
    """The tensor-map description of the bf16 kernels: a q/k/v third of the
    fused [B, T, 3·nh·d] projection is read in place (dims innermost first,
    byte strides of T, nh, B); a size-1 dim gets a contiguous stride; a
    stride off the 16-byte grid, a broadcast (0) stride or a non-contiguous
    last dim gives None."""
    b, t, nh, d = 2, 100, 3, 64
    qkv = torch.zeros(b, t, 3 * nh * d, dtype=torch.bfloat16)
    q, k, v = (x.unflatten(-1, (nh, d)).transpose(1, 2)
               for x in qkv.split(nh * d, dim=-1))
    desc = tfa._tma_desc(k)
    assert desc[0] == k.data_ptr() and desc[0] - q.data_ptr() == nh * d * 2
    assert desc[1:5] == [d, t, nh, b]
    assert desc[5:] == [3 * nh * d * 2, d * 2, t * 3 * nh * d * 2]
    one = torch.zeros(1, 1, 1, 70, dtype=torch.bfloat16)
    assert tfa._tma_desc(one)[5:] == [144, 144, 144]
    assert tfa._tma_desc(torch.zeros(1, 2, 3, 70, dtype=torch.bfloat16)) \
        is None                                          # 140-byte rows
    assert tfa._tma_desc(torch.zeros(2, 1, 1, 64).expand(2, 4, 1, 64)) \
        is None                                          # stride 0, size 4
    assert tfa._tma_desc(torch.zeros(1, 1, 64, 8).transpose(2, 3)) is None
    assert tfa._tma_desc(torch.zeros(1, 64)) is None     # not 4-D


def test_padded_rows_copies_only_off_the_grid():
    """lse and delta as [1, 1, B·nh, Tq] rows that start on the 16-byte
    grid: the forward's own padded lse is viewed in place, a ragged
    contiguous one is copied to rows of a multiple of 4 floats."""
    rows = torch.arange(6 * 8, dtype=torch.float32).reshape(6, 8)
    lse = rows[:, :7].view(2, 3, 7)          # the bf16 forward's layout
    v = tfa._padded_rows(lse, 6, 7)
    assert v.data_ptr() == lse.data_ptr() and v.stride()[2:] == (8, 1)
    ragged = torch.randn(2, 3, 7)
    w = tfa._padded_rows(ragged, 6, 7)
    assert w.data_ptr() != ragged.data_ptr() and w.stride()[2:] == (8, 1)
    torch.testing.assert_close(w.reshape(2, 3, 7), ragged, rtol=0, atol=0)
    assert tfa._tma_desc(w)[1:3] == [7, 6]


@pytest.mark.parametrize("shape,mode,compact,copied", [
    ((2, 1, 1, 128), 1, (2, 1, 1, 128), False),     # the BERT mask
    ((2, 1, 1, 100), 1, (2, 1, 1, 100), True),      # ragged Tk: rows padded
    ((2, 3, 128, 128), 2, (2, 3, 128, 128), False),  # per query
    ((128, 128), 2, (1, 1, 128, 128), False),        # per query, shared
    ((2, 1, 128, 1), 2, (2, 1, 128, 128), True),     # broadcast over keys
])
def test_bias_tile_keeps_broadcast_dims(shape, mode, compact, copied):
    b, nh, tq, tk = 2, 3, 128, shape[-1] if shape[-1] > 1 else 128
    q = torch.zeros(b, nh, tq, 64, dtype=torch.bfloat16)
    bias = torch.randn(*shape).to(torch.bfloat16)
    got_mode, desc, t = tfa._bias_tile(bias, q, tq, tk)
    assert got_mode == mode and tuple(t.shape) == compact
    assert t.dtype == torch.bfloat16 and desc == tfa._tma_desc(t)
    assert (t.data_ptr() != bias.data_ptr()) == copied
    torch.testing.assert_close(t.float().expand(b, nh, tq, tk),
                               bias.float().expand(b, nh, tq, tk),
                               rtol=0, atol=0)
    # an expanded bias is read as the row it repeats, without a copy
    full = torch.zeros(b, 1, 1, 128, dtype=torch.bfloat16).expand(b, nh, tq,
                                                                  128)
    _, _, tf = tfa._bias_tile(full, q, tq, 128)
    assert tf.shape == (b, 1, 1, 128) and tf.data_ptr() == full.data_ptr()
    assert tfa._bias_tile(None, q, tq, tk)[0] == 0
    with pytest.raises(ValueError, match="broadcast"):
        tfa._bias_tile(torch.zeros(3, 1, 1, tk), q, tq, tk)


def _cuda_qkv(b, nh, t, d, dtype, seed):
    """q, k, v as [B, nh, T, d] views of one fused [B, T, 3·nh·d] projection
    on the card."""
    g = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn(b, t, 3 * nh * d, generator=g, device="cuda").to(dtype)
    return [x.unflatten(-1, (nh, d)).transpose(1, 2)
            for x in qkv.split(nh * d, dim=-1)], g


@pytest.mark.cuda
def test_cuda_fwd_d128_causal_dropout_matches_plain():
    _cuda_or_skip()
    (q, k, v), _ = _cuda_qkv(2, 3, 130, 128, torch.bfloat16, 2)
    out, lse = tfa.flash_attention_fwd(q, k, v, None, True, None, 0.2, 9)
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, None, True,
                                                     None, 0.2, 9)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_grid_past_65535_heads():
    """B·nh = 65,600 at T = 64: the flat grids launch (the old (tile, B·nh)
    grid capped B·nh at 65,535); forward and backward against the plain
    versions."""
    _cuda_or_skip()
    (q, k, v), g = _cuda_qkv(50, 1312, 64, 64, torch.bfloat16, 3)
    out, lse = tfa.flash_attention_fwd(q, k, v)
    ref_out, _ = tfa.flash_attention_fwd_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, dout)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    for a, w in zip(got[:3], want[:3]):
        err = (a.float() - w.float()).abs().max().item()
        assert err <= 3e-2 * w.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["col", "per_q"])
def test_cuda_bwd_is_bitwise_repeatable(form):
    """Every output is written by one CTA in a fixed order: two calls give
    equal dq, dk, dv and dbias bit for bit (dropout on)."""
    _cuda_or_skip()
    (q, k, v), g = _cuda_qkv(2, 3, 200, 64, torch.bfloat16, 4)
    if form == "col":
        bias = torch.zeros(2, 1, 1, 200, device="cuda", dtype=q.dtype)
        bias[..., 150:] = -1e4
    else:
        bias = torch.randn(2, 3, 200, 200, generator=g,
                           device="cuda").to(q.dtype)
    out, lse = tfa.flash_attention_fwd(q, k, v, bias, False, None, 0.1, 7)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    first = tfa.flash_attention_bwd(q, k, v, out, lse, dout, bias, False,
                                    None, 0.1, 7, form)
    second = tfa.flash_attention_bwd(q, k, v, out, lse, dout, bias, False,
                                     None, 0.1, 7, form)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d", [(512, 64), (130, 128), (128, 192),
                                 (64, 256), (128, 320), (64, 512)])
def test_cuda_delta_kernel_matches_plain(t, d, dtype):
    _cuda_or_skip()
    (out, dout, _), _ = _cuda_qkv(2, 3, t, d, dtype, 5)
    got = tfa.flash_attention_delta(out, dout)
    want = tfa.flash_attention_delta_plain(out, dout)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_cuda_head_dim_32_takes_the_plain_route():
    """d = 32 on the card: the plain version, counted, no launch; d = 320
    launches the wide kernel once and counts no plain call."""
    _cuda_or_skip()
    (q, k, v), _ = _cuda_qkv(2, 12, 128, 32, torch.bfloat16, 6)
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_fwd.plain_on_cuda)
    out = tfa.flash_attention(q, k, v)
    assert out.shape == q.shape
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_fwd.plain_on_cuda) == (before[0],
                                                       before[1] + 1)
    (q, k, v), _ = _cuda_qkv(1, 1, 64, 320, torch.bfloat16, 6)
    fwd = tfa.flash_attention_fwd
    before = (fwd.launches, fwd.wide_launches, fwd.plain_on_cuda)
    tfa.flash_attention_fwd(q, k, v)
    assert (fwd.launches, fwd.wide_launches, fwd.plain_on_cuda) == (
        before[0] + 1, before[1] + 1, before[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fwd_tol,bwd_tol", [
    (torch.float32, 2e-5, 2e-5), (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("case", ["mask_dropout", "per_q_causal"])
def test_cuda_wide_kernels_match_plain(case, d, dtype, fwd_tol, bwd_tol):
    """The wide kernels (d >= 320) against the plain versions: the
    [B,1,1,T] mask with dropout (column-sum dbias) and a per-query bias,
    causal (per-query dbias; in f32 against the plain formula in f64), at a
    ragged T; one wide launch each, no plain call, and a second backward
    equal bit for bit."""
    _cuda_or_skip()
    (q, k, v), g = _cuda_qkv(2, 2, 200, d, dtype, 8)
    if case == "mask_dropout":
        bias = torch.zeros(2, 1, 1, 200, device="cuda", dtype=dtype)
        bias[..., 150:] = -1e4
        causal, rate, form = False, 0.1, "col"
    else:
        bias = torch.randn(2, 2, 200, 200, generator=g,
                           device="cuda").to(dtype)
        causal, rate, form = True, 0.0, "per_q"
    fwd, bwd = tfa.flash_attention_fwd, tfa.flash_attention_bwd
    before = [(f.launches, f.wide_launches, f.plain_on_cuda)
              for f in (fwd, bwd)]
    out, lse = fwd(q, k, v, bias, causal, None, rate, 5)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    got = bwd(q, k, v, out, lse, dout, bias, causal, None, rate, 5, form)
    assert [(f.launches, f.wide_launches, f.plain_on_cuda)
            for f in (fwd, bwd)] == [(n + 1, w + 1, p)
                                     for n, w, p in before]
    ref = tfa.flash_attention_fwd_plain(q, k, v, bias, causal, None, rate, 5)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, dout, bias,
                                         causal, None, rate, 5, form)
    for a, w in zip((out, lse), ref):
        torch.testing.assert_close(a.float(), w.float(), rtol=fwd_tol,
                                   atol=fwd_tol)
    for a, w in zip(got[:3], want[:3]):
        err = (a.float() - w.float()).abs().max().item()
        assert err <= bwd_tol * w.float().abs().max().item(), err
    ref_db = want[3]
    if form == "per_q" and dtype == torch.float32:
        # ds where dp − delta cancels (a causal row that sees one key): the
        # plain version's f32 dp is off by more than the tolerance at
        # d = 512, so the reference is its formula in f64
        ref_db = tfa.flash_attention_ds_f64(q, k, v, out, lse, dout, bias,
                                            causal, None, rate, 5)
    torch.testing.assert_close(got[3], ref_db.float(), rtol=2e-5, atol=2e-5)
    again = bwd(q, k, v, out, lse, dout, bias, causal, None, rate, 5, form)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# -- the bf16 wide forward (csrc/flash_attention_wide.cu, bfw) ---------------

def _wide_bf16_grid(b, nh, tq, tk, d, sms):
    """The bf16 wide forward's launch, replayed from the C source
    (bfw::chunks, split_of, ctas, place_of): output chunks of up to four
    64-wide blocks, a cluster of `split` CTAs splitting each walk where the
    cells fill over half the SMs and at most all of them and the walk has 8
    key tiles or more. Returns (nch, bpc, split, ctas)."""
    nblk = d // 64
    nch = -(-nblk // 4)
    bpc = -(-nblk // nch)
    cells = -(-tq // 64) * b * nh * nch
    nk = -(-tk // 64)
    split = 2 if 2 * cells > sms and cells <= sms and nk >= 8 else 1
    return nch, bpc, split, cells * split


def _wide_bf16_writes(b, nh, tq, tk, d, sms):
    """Replays every CTA's place (rank fastest, then chunk, q tile, b·h)
    and what it writes: the output blocks it finishes (all of its chunk's
    when split = 1, else those j ≡ rank mod 2 of them), the lse of its rows
    (rank 0 of chunk 0) and the key tiles its walk takes (kt ≡ rank mod
    split). Returns the counts: [B·nh, q tiles, 64-wide blocks] output
    blocks, [B·nh, q tiles] lse rows and [B·nh, q tiles, chunk, key tiles]
    walks."""
    nch, bpc, split, ctas = _wide_bf16_grid(b, nh, tq, tk, d, sms)
    nq, nk, nblk = -(-tq // 64), -(-tk // 64), d // 64
    x = np.arange(ctas, dtype=np.int64)
    rank, cell = x % split, x // split
    oc, tile, bh = cell % nch, (cell // nch) % nq, cell // (nch * nq)
    assert bpc <= 4 and bh.max() == b * nh - 1
    blocks = np.zeros((b * nh, nq, nblk), np.int64)
    for j in range(4):   # the kernel's unrolled output blocks
        mine = (oc * bpc + j < np.minimum(nblk, (oc + 1) * bpc)) & (
            (split == 1) | (j % split == rank))
        np.add.at(blocks, (bh[mine], tile[mine], (oc * bpc + j)[mine]), 1)
    rows = np.zeros((b * nh, nq), np.int64)
    first = (rank == 0) & (oc == 0)
    np.add.at(rows, (bh[first], tile[first]), 1)
    walks = np.zeros((b * nh, nq, nch, nk), np.int64)
    for kt in range(nk):
        mine = kt % split == rank
        np.add.at(walks, (bh[mine], tile[mine], oc[mine], kt), 1)
    return blocks, rows, walks, split, ctas


@pytest.mark.parametrize("d", [320, 384, 512, 1024])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", [
    (4, 2, 512, 512),     # the wide path's dense shape (BERT hidden 1024)
    (4, 2, 256, 256),     # its sparse shape (Transformer-big encoder self)
    (4, 2, 128, 128),     # BERT at T = 128
    (2, 2, 200, 200),     # a ragged T
    (50, 1312, 64, 64),   # B·nh = 65,600: past the 65,535 grid cap
])
def test_wide_bf16_forward_grid_writes_each_output_once(shape, sms, d):
    """Every 64x64 output block of [B, nh, T, d] is written by exactly one
    CTA of the bf16 wide forward's flat grid, every row's lse once, and
    every key tile is walked by exactly one CTA of each (chunk, q tile):
    at d = 320 to 1024, on a card of 132 SMs and of 114. At d = 512 the
    chunks are two (S formed twice a pair); on 132 SMs the dense shape's
    128 cells split each walk over a cluster of two, on 114 they do not
    (the cells alone fill the card), and the sparse shape never does."""
    b, nh, t, tk = shape
    blocks, rows, walks, split, ctas = _wide_bf16_writes(b, nh, t, tk, d,
                                                         sms)
    assert (blocks == 1).all() and (rows == 1).all() and (walks == 1).all()
    assert ctas < 2 ** 31
    if d == 512:
        assert _wide_bf16_grid(b, nh, t, tk, d, sms)[0] == 2
        assert split == (2 if shape == (4, 2, 512, 512) and sms == 132
                         else 1)


def test_wide_bf16_forward_reads_packed_heads_and_mask_in_place():
    """The bf16 wide forward's TMA maps read q, k, v as [B, nh, T, d] head
    views of a packed [B, T, nh·d] projection and the [B, 1, 1, T] mask in
    place, at d = 320 and 512 and a ragged T: no copy; a tensor whose last
    dim is not contiguous is copied, never refused; the sparse walk's se
    from pack_se is read in place too."""
    for d, t in ((320, 200), (512, 256)):
        b, nh = 2, 2
        qkv = torch.zeros(b, t, 3 * nh * d, dtype=torch.bfloat16)
        q, k, v = (x.unflatten(-1, (nh, d)).transpose(1, 2)
                   for x in qkv.split(nh * d, dim=-1))
        mask = torch.zeros(b, 1, 1, t, dtype=torch.bfloat16)
        ts, descs, mode = tfa._wide_fwd_bf16_tensors(q, k, v, mask)
        assert [x.data_ptr() for x in ts] == [x.data_ptr()
                                              for x in (q, k, v, mask)]
        assert mode == 1 and descs[3] == tfa._tma_desc(mask)
        assert descs[0][1:] == [d, t, nh, b, 3 * nh * d * 2, d * 2,
                                t * 3 * nh * d * 2]
        assert descs[1][0] - descs[0][0] == nh * d * 2
        ts, descs, mode = tfa._wide_fwd_bf16_tensors(q, k, v, None)
        assert mode == 0 and ts[3] is None and descs[3] == [0] * 8
    qt = torch.zeros(b, nh, d, t, dtype=torch.bfloat16).transpose(2, 3)
    ts, descs, _ = tfa._wide_fwd_bf16_tensors(qt, k, v, None)
    assert ts[0].data_ptr() != qt.data_ptr() and ts[0].is_contiguous()
    assert torch.equal(ts[0], qt) and descs[0] == tfa._tma_desc(ts[0])
    from paddle_tpu_torch.ops.kernels import flash_attention_sparse as fas

    seg = torch.tensor([[1] * 100 + [2] * 156, [1] * 256], dtype=torch.int32)
    se = fas.pack_se(seg, seg)
    assert se.is_contiguous() and se.contiguous().data_ptr() == se.data_ptr()


@pytest.mark.parametrize("d", [320, 512])
def test_wide_bf16_forward_matches_pallas_interpret(d, monkeypatch):
    """The bf16 forward at d = 320 and 512 (the wide kernel's plain version
    on the CPU) against the JAX package's Pallas forward in interpret mode
    on the same bf16 inputs, with the [B,1,1,T] mask, T = 128: within
    rtol = atol = 1e-2 (both round P and the output to bf16, at different
    points; half a bf16 ulp at |x| < 2 is below 4e-3)."""
    monkeypatch.setattr(jfa, "FORCE_PALLAS_INTERPRET", True)
    b, h, t = 1, 2, 128
    assert jfa._pallas_ok(t, d)
    q, k, v = (_rand((b, h, t, d), 50 + i, 0.5) for i in range(3))
    mask = np.where(np.random.RandomState(9).rand(b, 1, 1, t) > 0.25, 0.0,
                    -1e4).astype(np.float32)
    want = jfa.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        bias=jnp.asarray(mask, jnp.bfloat16))
    out, lse = tfa.flash_attention_fwd(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(mask).bfloat16())
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d,t,b,nh", [
    (320, 200, 2, 2), (512, 200, 2, 2), (320, 512, 4, 2), (512, 512, 4, 2),
    (320, 64, 50, 1312)])
def test_cuda_wide_bf16_forward_entry(d, t, b, nh):
    """The bf16 wide forward on the card against its plain version at a
    ragged T, the wide path's dense shape and B·nh = 65,600: the mask with
    dropout and a per-query bias, causal (out and lse within 2e-2); one
    wide launch a call, no plain call; a second call equal bit for bit; its
    CTAs, and the backward's, those of the replayed grids on this card."""
    _cuda_or_skip()
    from paddle_tpu_torch.ops.kernels import build

    (q, k, v), g = _cuda_qkv(b, nh, t, d, torch.bfloat16, 11)
    mask = torch.zeros(b, 1, 1, t, device="cuda", dtype=torch.bfloat16)
    mask[..., 3 * t // 4:] = -1e4
    cases = [(mask, False, 0.1)]
    if b * nh < 1000:
        cases.append((torch.randn(b, nh, t, t, generator=g, device="cuda")
                      .to(torch.bfloat16), True, 0.0))
    fwd = tfa.flash_attention_fwd
    for bias, causal, rate in cases:
        before = (fwd.launches, fwd.wide_launches, fwd.plain_on_cuda)
        out, lse = fwd(q, k, v, bias, causal, None, rate, 5)
        again = fwd(q, k, v, bias, causal, None, rate, 5)
        assert (fwd.launches, fwd.wide_launches, fwd.plain_on_cuda) == (
            before[0] + 2, before[1] + 2, before[2])
        ref = tfa.flash_attention_fwd_plain(q, k, v, bias, causal, None,
                                            rate, 5)
        for a, w in zip((out, lse), ref):
            torch.testing.assert_close(a.float(), w.float(), rtol=2e-2,
                                       atol=2e-2)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    query = build.load("flash_attention_wide").flash_attention_wide_ctas
    query.argtypes = [ctypes.c_int] * 7
    query.restype = ctypes.c_longlong
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert query(0, 1, b, nh, t, t, d) == _wide_bf16_grid(b, nh, t, t, d,
                                                          sms)[3]
    assert query(1, 1, b, nh, t, t, d) == _wide_bf16_bwd_writes(
        b, nh, t, t, d)[4]


# -- the bf16 wide backward (csrc/flash_attention_wide.cu, bwb) --------------

def _wide_bf16_bwd_writes(b, nh, tq, tk, d, causal=False, vis=None):
    """The bf16 wide backward's launch, replayed from the C source
    (bwb::cells, ctas, role_cta and bfw::chunks): the dk CTAs, then the dq
    CTAs, then the dv CTAs of one flat grid, each numbered in its role's
    grid with the chunk fastest, then the row tile, then b·h; a chunk holds
    up to four 64-wide output blocks (chunks ceil(d / 256)); a CTA walks
    the column tiles it sees (dense causal: dq up to the diagonal, dk and dv
    from it; sparse: the bits of its row or column of `vis`). Returns the
    counts: per role the [B·nh, row tiles, 64-wide blocks] output blocks it
    writes; the per-query dbias blocks [B·nh, q tiles, key tiles] (dq,
    chunk 0, dense) and column-dbias tiles [B·nh, key tiles] (dk, chunk 0,
    dense); per role the walks [B·nh, q tiles, key tiles, chunk]; the CTAs
    and the flops a visible (query, key) pair costs over all roles."""
    nblk, nq, nk = d // 64, -(-tq // 64), -(-tk // 64)
    nch = -(-nblk // 4)
    bpc = -(-nblk // nch)
    n_dk, n_dq = nk * b * nh * nch, nq * b * nh * nch
    ctas = 2 * n_dk + n_dq
    x = np.arange(ctas, dtype=np.int64)
    role = np.where(x < n_dk, 0, np.where(x < n_dk + n_dq, 1, 2))
    local = x - np.array([0, n_dk, n_dk + n_dq])[role]
    oc, cell = local % nch, local // nch
    nrt = np.where(role == 1, nq, nk)
    tile, bh = cell % nrt, cell // nrt
    assert bh.max() == b * nh - 1
    names = ("dk", "dq", "dv")
    blocks = {n: np.zeros((b * nh, nq if n == "dq" else nk, nblk), np.int64)
              for n in names}
    walks = {n: np.zeros((b * nh, nq, nk, nch), np.int64) for n in names}
    per_q = np.zeros((b * nh, nq, nk), np.int64)
    col = np.zeros((b * nh, nk), np.int64)
    for r, n in enumerate(names):
        for j in range(4):   # the kernel's unrolled output blocks
            mine = (role == r) & (oc * bpc + j < np.minimum(nblk,
                                                          (oc + 1) * bpc))
            np.add.at(blocks[n], (bh[mine], tile[mine], (oc * bpc + j)[mine]),
                      1)
    for ct in range(max(nq, nk)):   # the walks' column tiles
        qt = np.where(role == 1, tile, ct)
        kt = np.where(role == 1, ct, tile)
        seen = ct < np.where(role == 1, nk, nq)
        if vis is not None:
            seen &= vis[bh // nh, np.minimum(qt, nq - 1),
                        np.minimum(kt, nk - 1)] != 0
        elif causal:
            seen &= np.where(role == 1, ct <= (np.minimum(tile * 64 + 64, tq)
                                               - 1) // 64, ct >= tile)
        for r, n in enumerate(names):
            mine = seen & (role == r)
            np.add.at(walks[n], (bh[mine], qt[mine], kt[mine], oc[mine]), 1)
        if vis is None:
            mine = seen & (role == 1) & (oc == 0)
            np.add.at(per_q, (bh[mine], qt[mine], kt[mine]), 1)
    if vis is None:
        mine = (role == 0) & (oc == 0)
        np.add.at(col, (bh[mine], tile[mine]), 1)
    # flops a pair: each chunk of each role forms S (2d), dq and dk dP (2d);
    # the output products sum to 2d a role over the chunks
    flops = nch * (3 + 2) * 2 * d + 3 * 2 * d
    return blocks, per_q, col, walks, ctas, flops


@pytest.mark.parametrize("d", [320, 384, 512, 1024])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape,kind", [
    ((4, 2, 512, 512), "dense"),    # the wide path's dense shape
    ((4, 2, 512, 512), "causal"),
    ((4, 2, 256, 256), "sparse"),   # its sparse shape (encoder self)
    ((4, 2, 256, 256), "sparse causal"),
    ((2, 2, 200, 200), "causal"),   # a ragged T
    ((50, 1312, 64, 64), "dense"),  # B·nh = 65,600: past the 65,535 cap
])
def test_wide_bf16_backward_grid_writes_each_output_once(shape, kind, sms,
                                                         d):
    """Every 64x64 block of dq, dk and dv is written by exactly one CTA of
    the bf16 wide backward's flat grid (the dk, dq and dv CTAs of one
    launch), each per-query dbias block the dq walk visits and each
    column-dbias tile once, and each visible (q tile, key tile) pair is
    walked exactly once by each (role, chunk), other pairs never: at d =
    320 to 1024, dense (causal or not) and block-sparse on packed NMT rows.
    The grid does not depend on the card's SMs (132 or 114). At d = 512 a
    pair costs 26·d flops over the three roles (at most 30·d)."""
    b, nh, t, tk = shape
    causal = "causal" in kind
    vis = None
    nq, nk = -(-t // 64), -(-tk // 64)
    visible = np.ones((b, nq, nk), bool)
    if kind.startswith("sparse"):
        seg = torch.tensor(_packed_rows(b, t))
        vis = tfas.compute_block_vis(tfas.pack_se(seg, seg), t, tk,
                                          causal=causal).numpy()
        visible = vis != 0
    elif causal:
        visible = np.tril(np.ones((nq, nk), bool))[None].repeat(b, 0)
    blocks, per_q, col, walks, ctas, flops = _wide_bf16_bwd_writes(
        b, nh, t, tk, d, causal, vis)
    for n in ("dq", "dk", "dv"):
        assert (blocks[n] == 1).all(), n
        want = np.repeat(visible, nh, 0)[..., None].repeat(walks[n].shape[-1],
                                                            -1)
        assert (walks[n] == want).all(), n
    if vis is None:
        assert (per_q == np.repeat(visible, nh, 0)).all()
        assert (col == 1).all()
    assert ctas < 2 ** 31
    assert ctas == 3 * nq * b * nh * -(-d // 256)   # Tq = Tk here
    if d == 512:
        assert flops == 26 * d <= 30 * d


def _packed_rows(b, t, seed=4):
    """[b, t] segment ids of packed rows of sentences of 4 to 60 tokens
    (pad at the end of each row), as reader.pack_by_tokens fills them."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((b, t), np.int32)
    for i in range(b):
        pos, sid = 0, 1
        while True:
            n = int(rng.randint(4, 61))
            if pos + n > t - 8:
                break
            seg[i, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return seg


def test_wide_bf16_backward_reads_packed_heads_and_rows_in_place():
    """The bf16 wide backward's TMA maps read q, k, v and dO as [B, nh, T,
    d] head views of packed [B, T, nh·d] projections, the [B, 1, 1, T] mask,
    and the lse and delta rows ([B·nh, pitch] buffers, pitch Tq rounded up
    to 4 floats) by their pitch, all in place, at d = 320 and 512 and a
    ragged T; se's [1, 1, B, Tq] view in place too; a tensor whose last dim
    is not contiguous is copied, never refused, and lse rows off the
    16-byte grid are copied onto it."""
    for d, t in ((320, 200), (512, 256)):
        b, nh = 2, 2
        qkv = torch.zeros(b, t, 3 * nh * d, dtype=torch.bfloat16)
        q, k, v = (x.unflatten(-1, (nh, d)).transpose(1, 2)
                   for x in qkv.split(nh * d, dim=-1))
        g = torch.zeros(b, t, nh * d, dtype=torch.bfloat16).unflatten(
            -1, (nh, d)).transpose(1, 2)
        pitch = -(-t // 4) * 4
        lse = torch.zeros(b * nh, pitch)[:, :t].view(b, nh, t)
        delta = torch.zeros(b * nh, pitch)[:, :t]
        mask = torch.zeros(b, 1, 1, t, dtype=torch.bfloat16)
        ts, descs, mode = tfa._wide_bwd_bf16_tensors(q, k, v, g, mask, lse,
                                                     delta, None)
        assert [x.data_ptr() for x in ts[:7]] == [
            x.data_ptr() for x in (q, k, v, g, mask, lse, delta)]
        assert mode == 1 and descs[4] == tfa._tma_desc(mask)
        assert descs[0][1:] == [d, t, nh, b, 3 * nh * d * 2, d * 2,
                                t * 3 * nh * d * 2]
        assert descs[3][1:] == [d, t, nh, b, nh * d * 2, d * 2,
                                t * nh * d * 2]
        for desc, x in zip(descs[5:7], (lse, delta)):
            assert desc == [x.data_ptr(), t, b * nh, 1, 1, pitch * 4,
                            b * nh * pitch * 4, b * nh * pitch * 4]
        assert ts[7] is None and descs[7] == [0] * 8
    seg = torch.tensor(_packed_rows(b, t))
    se = tfas.pack_se(seg, seg)
    ts, descs, mode = tfa._wide_bwd_bf16_tensors(q, k, v, g, None, lse,
                                                 delta, se)
    assert mode == 0 and ts[4] is None and descs[4] == [0] * 8
    assert ts[7].data_ptr() == se.data_ptr()
    assert descs[7] == [se.data_ptr(), t, b, 1, 1, t * 4, b * t * 4,
                        b * t * 4]
    qt = torch.zeros(b, nh, d, t, dtype=torch.bfloat16).transpose(2, 3)
    lse_off = torch.zeros(b * nh, t + 1)[:, :t]   # rows 4·257 bytes apart
    ts, descs, _ = tfa._wide_bwd_bf16_tensors(qt, k, v, qt, None, lse_off,
                                              delta, None)
    assert ts[0].data_ptr() != qt.data_ptr() and ts[0].is_contiguous()
    assert torch.equal(ts[0], qt) and descs[0] == tfa._tma_desc(ts[0])
    assert ts[5].data_ptr() != lse_off.data_ptr()
    assert torch.equal(ts[5][0, 0], lse_off) and descs[5][5] == t * 4


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("case", ["mask", "per_q_causal"])
def test_wide_bf16_backward_matches_pallas_interpret(case, d, monkeypatch):
    """The bf16 backward at d = 320 and 512 (the wide kernel's plain
    version on the CPU) against jax.vjp through the JAX package's Pallas
    kernels in interpret mode, on the same bf16 inputs and cotangent, T =
    128: with the [B,1,1,T] mask (its column-sum dbias) and with a
    per-query bias, causal (its dbias is ds): dq, dk, dv and dbias each
    within 1e-2 of its largest |value| (both round P, dS and dO to bf16
    before their products, at different points, and the gradients to bf16;
    the card's bf16 backward is held to the plain version as closely)."""
    import jax

    monkeypatch.setattr(jfa, "FORCE_PALLAS_INTERPRET", True)
    b, h, t = 1, 2, 128
    assert jfa._pallas_ok(t, d)
    q, k, v, dy = (_rand((b, h, t, d), 90 + i, 0.5) for i in range(4))
    if case == "mask":
        bias = np.where(np.random.RandomState(9).rand(b, 1, 1, t) > 0.25,
                        0.0, -1e4).astype(np.float32)
    else:
        bias = _rand((b, h, t, t), 95, 0.5)
    causal = case.endswith("causal")

    def f(q_, k_, v_, b_):
        return jfa.flash_attention(q_, k_, v_, bias=b_, causal=causal)

    _, vjp = jax.vjp(f, *(jnp.asarray(x, jnp.bfloat16)
                          for x in (q, k, v, bias)))
    want = vjp(jnp.asarray(dy, jnp.bfloat16))
    targs = [torch.from_numpy(x).bfloat16().requires_grad_()
             for x in (q, k, v, bias)]
    out = tfa.flash_attention(*targs[:3], bias=targs[3], causal=causal)
    got = torch.autograd.grad(out, targs, torch.from_numpy(dy).bfloat16())
    for a, w, name in zip(got, want, ("dq", "dk", "dv", "dbias")):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape, name
        a, w = a.float().numpy(), np.asarray(w).astype(np.float32)
        assert np.abs(a - w).max() <= 1e-2 * np.abs(w).max(), name


@pytest.mark.cuda
@pytest.mark.parametrize("d,t,b,nh", [
    (320, 200, 2, 2), (512, 200, 2, 2), (512, 512, 4, 2), (1024, 256, 1, 2)])
def test_cuda_wide_bf16_backward_entry(d, t, b, nh):
    """The bf16 wide backward (flash_attention_wide_bwd_bf16) on the card
    against its plain version at a ragged T, the wide path's dense shape
    and d = 1024: the mask with dropout (column-sum dbias) and a per-query
    bias, causal (per-query dbias), then block-sparse causal with dropout
    where T is a multiple of 64; dq, dk, dv within 1e-2 of their largest
    |value|, the column-sum dbias within 2e-5 of the plain version's, the
    per-query one within 2e-5 of the plain formula in f64 (the plain
    version's f32 dp is off by more at d = 1024); one wide launch a call,
    no plain call; a second call equal bit for bit; its CTAs those of the
    replayed grid."""
    _cuda_or_skip()
    from paddle_tpu_torch.ops.kernels import build

    (q, k, v), g = _cuda_qkv(b, nh, t, d, torch.bfloat16, 12)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    mask = torch.zeros(b, 1, 1, t, device="cuda", dtype=torch.bfloat16)
    mask[..., 3 * t // 4:] = -1e4
    per_q = torch.randn(b, nh, t, t, generator=g,
                        device="cuda").to(torch.bfloat16)
    bwd = tfa.flash_attention_bwd
    for bias, causal, rate, form in ((mask, False, 0.1, "col"),
                                     (per_q, True, 0.0, "per_q")):
        out, lse = tfa.flash_attention_fwd(q, k, v, bias, causal, None, rate,
                                           5)
        before = (bwd.launches, bwd.wide_launches, bwd.plain_on_cuda)
        got = bwd(q, k, v, out, lse, dout, bias, causal, None, rate, 5, form)
        again = bwd(q, k, v, out, lse, dout, bias, causal, None, rate, 5,
                    form)
        assert (bwd.launches, bwd.wide_launches, bwd.plain_on_cuda) == (
            before[0] + 2, before[1] + 2, before[2])
        want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, dout, bias,
                                             causal, None, rate, 5, form)
        for a, w in zip(got[:3], want[:3]):
            err = (a.float() - w.float()).abs().max().item()
            assert err <= 1e-2 * w.float().abs().max().item(), err
        ref_db = want[3] if form == "col" else tfa.flash_attention_ds_f64(
            q, k, v, out, lse, dout, bias, causal, None, rate, 5).float()
        torch.testing.assert_close(got[3], ref_db, rtol=2e-5, atol=2e-5)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
    if t % 64 == 0:
        seg = torch.tensor(_packed_rows(b, t), device="cuda")
        se = tfas.pack_se(seg, seg)
        vis = tfas.compute_block_vis(se, t, t, causal=True)
        sbwd = tfas.flash_attention_sparse_bwd
        out, lse = tfas.flash_attention_sparse_fwd(q, k, v, se, vis, True,
                                                   None, 0.1, 5)
        before = (sbwd.launches, sbwd.wide_launches, sbwd.plain_on_cuda)
        got = sbwd(q, k, v, out, lse, dout, se, vis, True, None, 0.1, 5)
        assert (sbwd.launches, sbwd.wide_launches, sbwd.plain_on_cuda) == (
            before[0] + 1, before[1] + 1, before[2])
        want = tfas.flash_attention_sparse_bwd_plain(
            q, k, v, out, lse, dout, se, vis, True, None, 0.1, 5)
        for a, w in zip(got, want):
            err = (a.float() - w.float()).abs().max().item()
            assert err <= 1e-2 * w.float().abs().max().item(), err
        ones = torch.ones_like(vis)
        assert all(torch.equal(x, y) for x, y in zip(got, sbwd(
            q, k, v, out, lse, dout, se, ones, True, None, 0.1, 5)))
    query = build.load("flash_attention_wide").flash_attention_wide_ctas
    query.argtypes = [ctypes.c_int] * 7
    query.restype = ctypes.c_longlong
    assert query(1, 1, b, nh, t, t, d) == _wide_bf16_bwd_writes(
        b, nh, t, t, d)[4]
