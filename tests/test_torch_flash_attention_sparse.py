"""The port's block-sparse packed-segment attention against the JAX package's
``flash_attention_packed_sparse``, on the CPU.

On a CPU tensor the port runs the kernels' plain versions
(ops/kernels/flash_attention_sparse.py); the JAX side runs its blockwise
fallback, or its Pallas kernels in interpret mode (FORCE_PALLAS_INTERPRET).
The same numpy inputs go to both. Tolerances are the JAX package's own:
forward 2e-5 (rtol = atol), gradients rtol 1e-4 / atol 2e-4 (the two sum in
other orders). Pad rows and their gradients must be exactly 0, and skipping
a tile must be bitwise invisible. Dropout is compared within the port only:
the port draws Philox bits, the TPU kernels their core PRNG's."""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import reader
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import flash_attention_sparse as fas
from paddle_tpu_torch.ops.kernels.tf32x3 import mm_3xtf32, mm_3xtf32_groups

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-4)


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


def _jfa():
    # the JAX package re-exports the flash_attention function under the
    # module's name: import the module explicitly
    return importlib.import_module(
        "paddle_tpu.ops.pallas_kernels.flash_attention")


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _uneven_segs(b, t, rng, max_seg=4, pad_last=True):
    """Packed rows with uneven segment boundaries; row b-1 gets a long pad
    tail, row 0 is entirely pad (a fully masked query/key row). The twin of
    the JAX tests' helper."""
    segs = np.zeros((b, t), np.int32)
    for i in range(1, b):
        pos = 0
        for sid in range(1, max_seg + 1):
            ln = int(rng.randint(3, max(4, t // max_seg)))
            if pos + ln > t or (sid == max_seg and pad_last and i == b - 1):
                break
            segs[i, pos:pos + ln] = sid
            pos += ln
    return segs


def _port(q, k, v, nh, q_seg, k_seg, dy, causal=False, rate=0.0, seed=None):
    """The port's forward and (dq, dk, dv) of sum(out · dy)."""
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fas.flash_attention_packed_sparse(
        qt, kt, vt, nh, torch.tensor(q_seg), torch.tensor(k_seg),
        causal=causal, dropout_rate=rate, seed=seed)
    grads = torch.autograd.grad((out * torch.tensor(dy)).sum(), (qt, kt, vt))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _jax(q, k, v, nh, q_seg, k_seg, dy, causal=False):
    import jax
    import jax.numpy as jnp

    fa = _jfa()
    args = [jnp.asarray(x) for x in (q, k, v)]

    def f(*a):
        return fa.flash_attention_packed_sparse(*a, nh, q_seg, k_seg,
                                                causal=causal)

    out = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(dy)),
                     argnums=(0, 1, 2))(*args)
    return [np.asarray(x) for x in (out,) + tuple(grads)]


def _assert_match(port, jax_out, pad_rows=()):
    for i, (a, r, nm) in enumerate(zip(port, jax_out,
                                       ("out", "dq", "dk", "dv"))):
        np.testing.assert_allclose(a, r, err_msg=nm,
                                   **(FWD_TOL if i == 0 else GRAD_TOL))
        for row in pad_rows:  # exactly zero, not just close
            assert not a[row].any(), (nm, row)


@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_fallback(causal):
    """(a) JAX's blockwise fallback (blocks < 64): uneven segments with an
    all-pad row, forward and all three gradients."""
    b, t, nh, d = 3, 48, 2, 16
    seg = _uneven_segs(b, t, np.random.RandomState(0))
    q, k, v, dy = (_rand((b, t, nh * d), i) for i in (0, 1, 2, 7))
    _assert_match(_port(q, k, v, nh, seg, seg, dy, causal),
                  _jax(q, k, v, nh, seg, seg, dy, causal), pad_rows=(0,))


@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_pallas_interpret(causal):
    """(b) JAX's Pallas kernels in interpret mode, at the 64-token tiles of
    the CUDA kernels (T = 128: two tiles each way)."""
    fa = _jfa()
    b, t, nh, d = 2, 128, 2, 64
    seg = _uneven_segs(b, t, np.random.RandomState(1), max_seg=3)
    q, k, v, dy = (_rand((b, t, nh * d), i) for i in (0, 1, 2, 9))
    fa.FORCE_PALLAS_INTERPRET = True
    try:
        assert fa._sparse_pallas_ok(t, t, d)
        ref = _jax(q, k, v, nh, seg, seg, dy, causal)
    finally:
        fa.FORCE_PALLAS_INTERPRET = False
    _assert_match(_port(q, k, v, nh, seg, seg, dy, causal), ref,
                  pad_rows=(0,))


def test_cross_attention_matches_jax():
    """(c) cross attention, Tq = 40 != Tk = 56: decoder rows attend their
    own source segment only."""
    b, tq, tk, nh, d = 2, 40, 56, 2, 16
    rng = np.random.RandomState(4)
    q_seg = _uneven_segs(b, tq, rng, max_seg=3)
    k_seg = _uneven_segs(b, tk, rng, max_seg=3)
    q, dy = _rand((b, tq, nh * d), 0), _rand((b, tq, nh * d), 8)
    k, v = _rand((b, tk, nh * d), 1), _rand((b, tk, nh * d), 2)
    _assert_match(_port(q, k, v, nh, q_seg, k_seg, dy),
                  _jax(q, k, v, nh, q_seg, k_seg, dy), pad_rows=(0,))


@pytest.mark.parametrize("tq,tk,block,causal", [
    (128, 128, 64, False), (128, 128, 64, True), (128, 192, 64, False),
    (48, 48, 16, True), (40, 56, 8, False)])
def test_descriptor_and_tile_table_equal_jax(tq, tk, block, causal):
    """pack_se and compute_block_vis give JAX's bits exactly."""
    fa = _jfa()
    rng = np.random.RandomState(tq + tk + block)
    q_seg = _uneven_segs(3, tq, rng, max_seg=3)
    k_seg = q_seg if tq == tk else _uneven_segs(3, tk, rng, max_seg=3)
    se = fas.pack_se(torch.tensor(q_seg), torch.tensor(k_seg))
    jse = fa._pack_se(q_seg, k_seg)
    np.testing.assert_array_equal(se.numpy(), np.asarray(jse))
    vis = fas.compute_block_vis(se, tq, tk, block, block, causal)
    jvis = fa._compute_block_vis(jse, tq, tk, block, block, causal)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    # the all-pad row sees nothing, so it skips every tile
    assert not vis[0].any()


@pytest.mark.parametrize("dropout", [0.0, 0.15])
def test_tile_skip_is_bitwise_invisible(dropout, monkeypatch):
    """The twin of test_sparse_block_skip_is_bitwise_invisible: the computed
    tile table against an all-ones one, forward and backward, causal, with
    dropout on. The plain versions apply the table as the kernels do."""
    b, t, nh, d = 2, 128, 2, 64
    seg = _uneven_segs(b, t, np.random.RandomState(2), max_seg=3)
    q, k, v, dy = (_rand((b, t, nh * d), i) for i in (0, 1, 2, 5))
    seed = 11 if dropout else None
    skipping = _port(q, k, v, nh, seg, seg, dy, True, dropout, seed)
    se = fas.pack_se(torch.tensor(seg), torch.tensor(seg))
    assert (fas.compute_block_vis(se, t, t, causal=True) == 0).any()
    monkeypatch.setattr(
        fas, "compute_block_vis",
        lambda se, tq, tk, bq, bk, causal: torch.ones(
            (se.shape[0], -(-tq // bq), -(-tk // bk)), dtype=torch.int32))
    every_tile = _port(q, k, v, nh, seg, seg, dy, True, dropout, seed)
    for a, r, nm in zip(skipping, every_tile, ("out", "dq", "dk", "dv")):
        np.testing.assert_array_equal(a, r, err_msg=nm)


def test_dropout_deterministic_scaled_and_seeded():
    """Same seed: bitwise the same; another seed: different; a kept
    probability is scaled by 1/(1 - rate), from the mask dropout_keep_mask
    draws (the one the kernels draw)."""
    b, t, nh, d, rate = 2, 48, 2, 16, 0.3
    seg = _uneven_segs(b, t, np.random.RandomState(6))
    q, k, v = (torch.tensor(_rand((b, t, nh * d), i)) for i in range(3))
    segt = torch.tensor(seg)
    run = lambda seed: fas.flash_attention_packed_sparse(
        q, k, v, nh, segt, segt, dropout_rate=rate, seed=seed)
    a1, a2, a3 = run(0), run(0), run(1)
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    assert (a1 - a3).abs().max() > 1e-4
    # the same function written out: softmax within the segment, the keep
    # mask of seed 0, kept p divided by (1 - rate)
    heads = lambda x: x.unflatten(-1, (nh, d)).transpose(1, 2)
    s = heads(q) @ heads(k).transpose(-1, -2) / np.sqrt(d)
    vis = torch.tensor((seg[:, :, None] == seg[:, None, :])
                       & (seg[:, :, None] > 0))[:, None]
    p = torch.softmax(s.masked_fill(~vis, -1e30), -1) * vis
    keep = tfa.dropout_keep_mask(0, rate, b, nh, t, t)
    want = (torch.where(keep, p / (1 - rate), torch.zeros_like(p))
            @ heads(v)).transpose(1, 2).reshape(b, t, nh * d)
    torch.testing.assert_close(a1, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["heads", "rate_high", "rate_negative",
                                  "no_seed", "causal_cross", "seg_shape",
                                  "tk_overflow", "no_block"])
def test_value_errors(case):
    """Every ValueError of JAX's flash_attention_packed_sparse, and the
    16-bit descriptor overflow of _pack_se. no_block: Tk = 100 has no
    power-of-two block divisor ≥ 8, and both packages raise the same words
    (_flash_sparse_fwd_dispatch), even with Tq = 96, which has one."""
    b, t, nh, d = 2, 16, 2, 8
    x = torch.zeros(b, t, nh * d)
    seg = torch.ones(b, t, dtype=torch.int32)
    call = dict(q=x, k=x, v=x, num_heads=nh, q_seg=seg, k_seg=seg)
    match = {"heads": "not divisible", "rate_high": "dropout_rate",
             "rate_negative": "dropout_rate", "no_seed": "requires a seed",
             "causal_cross": "causal requires", "seg_shape": "seg shapes",
             "tk_overflow": "overflows",
             "no_block": "seq len 100 has no power-of-two block divisor"}[case]
    if case == "no_block":
        import jax.numpy as jnp

        q = np.zeros((b, 96, nh * d), np.float32)
        kv = np.zeros((b, 100, nh * d), np.float32)
        q_seg, k_seg = np.ones((b, 96), np.int32), np.ones((b, 100), np.int32)
        with pytest.raises(ValueError, match=match):
            _jfa().flash_attention_packed_sparse(
                jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), nh, q_seg,
                k_seg)
        call.update(q=torch.tensor(q), k=torch.tensor(kv),
                    v=torch.tensor(kv), q_seg=torch.tensor(q_seg),
                    k_seg=torch.tensor(k_seg))
    if case == "heads":
        call["num_heads"] = 3
    elif case in ("rate_high", "rate_negative"):
        call.update(dropout_rate=1.0 if case == "rate_high" else -0.1, seed=1)
    elif case == "no_seed":
        call["dropout_rate"] = 0.1
    elif case == "causal_cross":
        call.update(k=torch.zeros(b, 2 * t, nh * d),
                    v=torch.zeros(b, 2 * t, nh * d),
                    k_seg=torch.ones(b, 2 * t, dtype=torch.int32),
                    causal=True)
    elif case == "seg_shape":
        call["q_seg"] = seg[:, :-1]
    elif case == "tk_overflow":
        long = torch.ones(b, 1 << 15, dtype=torch.int32)
        with pytest.raises(ValueError, match=match):
            fas.pack_se(seg, long)
        return
    with pytest.raises(ValueError, match=match):
        fas.flash_attention_packed_sparse(**call)


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
@pytest.mark.parametrize("t", [64, 96, 256])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 192, 256, 320, 384, 512,
                               1024])
def test_sparse_route_mirrors_sparse_pallas_ok(d, t, device_type,
                                               monkeypatch):
    """The port's static route for the sparse op: a CPU tensor takes the
    plain version; on the card Tq or Tk not a multiple of 64 (T = 96: no
    power-of-two block ≥ 64) or d % 64 != 0 takes it too (the JAX package's
    blockwise XLA path), and every other shape a kernel (d = 64 to 256 the
    tuned sparse kernels, d = 320 and up the wide kernels). The card's
    choice is _sparse_pallas_ok's (Pallas forced on), for self (Tq = Tk)
    and for cross attention against 256 keys, both ways round."""
    fa = _jfa()
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    for tq, tk in ((t, t), (t, 256), (256, t)):
        shape = (2, 3, tq, d)
        pallas = fa._sparse_pallas_ok(tq, tk, d)
        for dtype in (torch.float32, torch.bfloat16):
            if device_type == "cpu":
                assert fas.sparse_route(shape, tk, dtype, "cpu") == "plain"
            else:
                want = "kernel" if pallas else "plain"
                assert fas.sparse_route(shape, tk, dtype, device_type) == want
    assert (d >= 320) == (d % 64 == 0 and d not in tfa.HEAD_DIMS)


def test_sparse_route_rejects_other_dtypes_and_devices():
    with pytest.raises(TypeError, match="dtype"):
        fas.sparse_route((1, 1, 64, 64), 64, torch.float16, "cuda")
    with pytest.raises(ValueError, match="device type"):
        fas.sparse_route((1, 1, 64, 64), 64, torch.float32, "meta")


@pytest.mark.parametrize("d", [192, 256, 320, 512])
def test_wide_head_dims_match_jax_pallas_interpret(d):
    """d = 192 to 512, which the card sends to the kernels (the wide ones
    above 256) as JAX sends them to Pallas: JAX's Pallas kernels in
    interpret mode against the
    port, f32, at the 64-token tiles (T = 128), causal, out and all three
    gradients."""
    fa = _jfa()
    b, t, nh = 2, 128, 1
    seg = _uneven_segs(b, t, np.random.RandomState(12), max_seg=3)
    q, k, v, dy = (0.5 * _rand((b, t, nh * d), 30 + i) for i in range(4))
    fa.FORCE_PALLAS_INTERPRET = True
    try:
        assert fa._sparse_pallas_ok(t, t, d)
        ref = _jax(q, k, v, nh, seg, seg, dy, True)
    finally:
        fa.FORCE_PALLAS_INTERPRET = False
    _assert_match(_port(q, k, v, nh, seg, seg, dy, True), ref,
                  pad_rows=(0,))


def _packed_segs(b, t, seed):
    """src_seg, tgt_seg [b, t] of the first b rows reader.pack_by_tokens
    makes of a seeded stream of sentence pairs with the NMT bench's
    log-normal lengths (about 26 tokens)."""
    def pairs():
        rng = np.random.RandomState(seed)
        while True:
            ls = int(np.clip(rng.lognormal(3.1, 0.55), 4, 128))
            lt = int(np.clip(ls * rng.uniform(0.8, 1.25), 4, 128))
            yield np.ones(ls, np.int32), np.ones(lt, np.int32)

    rows = []
    for row in reader.pack_by_tokens(pairs, t, t)():
        rows.append(row)
        if len(rows) == b:
            return (np.stack([r["src_seg"] for r in rows]),
                    np.stack([r["tgt_seg"] for r in rows]))


def _scores_16(a, b):
    """S or dP as the tuned f32 kernels form them: 16-column partial sums
    over the head dim, in order."""
    return mm_3xtf32(a, b, 16)


def _sparse_bwd_3xtf32(q, k, v, out, lse, g, se, vis, causal, sm, rate=0.0,
                       seed=0, scores=_scores_16):
    """dq, dk, dv of the f32 block-sparse backward as its kernel computes
    them: a dq CTA walks the visible key tiles of its 64-row q tile, a dk/dv
    CTA the visible q tiles of its 64-key tile (the transposed walk); each
    recomputes S (Sᵀ = K·Qᵀ in dk/dv) and dP in 3xTF32, summed as `scores`
    sums them (the tuned kernel: 16-column partial sums; the wide ones,
    whose 32-row CTAs give the same sums: mm_3xtf32_groups), masks p to
    exactly 0 and adds its tile's dS·K (dSᵀ·Q and P_dropᵀ·dO) in 3xTF32
    into a zeroed partial sum, one round-to-nearest add a tile. delta is the
    plain delta; exp is exact here (the kernel uses ex2.approx). [B, nh, T,
    d] f32 tensors."""
    b, nh, tq, d = q.shape
    tk, t_ = k.shape[2], fas.TILE
    mask = fas._mask(se, None, tq, tk, causal)[:, 0]
    keep = (tfa.dropout_keep_mask(seed, rate, b, nh, tq, tk) if rate > 0.0
            else torch.ones(b, nh, tq, tk, dtype=torch.bool))
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    delta = tfa.flash_attention_delta_plain(out, g)
    tiles = lambda i: slice(i * t_, (i + 1) * t_)
    kt_ = lambda x: x.transpose(-1, -2)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    for bi in range(b):
        for iq in range(tq // t_):          # dq CTAs
            r = tiles(iq)
            acc = torch.zeros(nh, t_, d)
            for kt in range(tk // t_):
                if not vis[bi, iq, kt]:
                    continue
                c = tiles(kt)
                s = scores(q[bi, :, r], kt_(k[bi, :, c]))
                dp = scores(g[bi, :, r], kt_(v[bi, :, c]))
                p = torch.where(mask[bi, r, c],
                                torch.exp(s * sm - lse[bi, :, r, None]),
                                torch.zeros(()))
                dp = torch.where(keep[bi, :, r, c], dp * scale,
                                 torch.zeros(()))
                ds = p * (dp - delta[bi, :, r, None])
                acc = acc + mm_3xtf32(ds, k[bi, :, c])
            dq[bi, :, r] = acc * sm
        for kt in range(tk // t_):          # dk/dv CTAs
            c = tiles(kt)
            acc_k, acc_v = torch.zeros(nh, t_, d), torch.zeros(nh, t_, d)
            for iq in range(tq // t_):
                if not vis[bi, iq, kt]:
                    continue
                r = tiles(iq)
                st = scores(k[bi, :, c], kt_(q[bi, :, r]))
                dpt = scores(v[bi, :, c], kt_(g[bi, :, r]))
                pt = torch.where(kt_(mask[bi, r, c]),
                                 torch.exp(st * sm - lse[bi, :, None, r]),
                                 torch.zeros(()))
                kept = kt_(keep[bi, :, r, c])
                ds = pt * (torch.where(kept, dpt * scale, torch.zeros(()))
                           - delta[bi, :, None, r])
                p_drop = torch.where(kept, pt * scale, torch.zeros(()))
                acc_v = acc_v + mm_3xtf32(p_drop, g[bi, :, r])
                acc_k = acc_k + mm_3xtf32(ds, q[bi, :, r])
            dk[bi, :, c] = acc_k * sm
            dv[bi, :, c] = acc_v
    return dq, dk, dv


_MODEL_CASES = {   # name: (d, causal, Tq, pad row): NMT-packed segments
    "encoder self": (64, False, 256, True),
    "encoder self d=128": (128, False, 128, True),
    "causal self": (64, True, 256, False),
    "cross Tq=192": (64, False, 192, False)}
# the forward's cases add d = 256, where a CTA owns one 64-wide output chunk
_FWD_CASES = {**_MODEL_CASES,
              "encoder self d=256": (256, False, 256, True),
              "causal self d=256": (256, True, 256, False),
              "cross Tq=192 d=256": (256, False, 192, False)}


def _model_case(name):
    d, causal, tq, pad = _FWD_CASES[name]
    tk, nh = 256 if tq == 192 else tq, 1
    src, tgt = _packed_segs(2, tk, 21)
    if pad:
        src[-1] = 0                                   # one all-pad row
    q_seg, k_seg = {"encoder": (src, src), "causal": (tgt, tgt),
                    "cross": (tgt[:, :tq], src)}[name.split()[0]]
    q, dy = (0.5 * _rand((2, tq, nh * d), 40 + i) for i in (0, 3))
    k, v = (0.5 * _rand((2, tk, nh * d), 40 + i) for i in (1, 2))
    return q, k, v, dy, q_seg, k_seg, nh, d, causal


@pytest.mark.parametrize("name", list(_MODEL_CASES))
def test_3xtf32_products_hold_the_sparse_f32_backward(name):
    """The decision rule of the f32 sparse backward's 3xTF32 design: its
    arithmetic, emulated on the CPU (_sparse_bwd_3xtf32: the visible-tile
    walks, 3xTF32 products with the tensor core's round-toward-zero sums,
    the partial sums), against the JAX package's _flash_bwd_pallas_sparse
    in interpret mode, on segment rows of reader.pack_by_tokens: dq, dk
    and dv within chip_smoke's f32 BWD_TOL (2e-5 of max(|ref|, 1)); pad
    rows exactly zero."""
    fa = _jfa()
    q, k, v, dy, q_seg, k_seg, nh, d, causal = _model_case(name)
    b, tq, tk = q.shape[0], q.shape[1], k.shape[1]
    fa.FORCE_PALLAS_INTERPRET = True
    try:
        assert fa._sparse_pallas_ok(tq, tk, d)
        ref = _jax(q, k, v, nh, q_seg, k_seg, dy, causal)[1:]
    finally:
        fa.FORCE_PALLAS_INTERPRET = False
    heads = lambda x: torch.tensor(x).unflatten(-1, (nh, d)).transpose(1, 2)
    qh, kh, vh, gh = (heads(x) for x in (q, k, v, dy))
    se = fas.pack_se(torch.tensor(q_seg), torch.tensor(k_seg))
    vis = fas.compute_block_vis(se, tq, tk, causal=causal)
    assert not vis.all(), "the case must skip tiles"
    sm = 1.0 / np.sqrt(d)
    out, lse = fas.flash_attention_sparse_fwd_plain(qh, kh, vh, se, vis,
                                                    causal, sm)
    got = _sparse_bwd_3xtf32(qh, kh, vh, out, lse, gh, se, vis, causal, sm)
    for nm, a, r in zip(("dq", "dk", "dv"), got, ref):
        a = a.transpose(1, 2).reshape(r.shape).numpy()
        err = np.abs(a - r).max()
        assert err <= 2e-5 * max(np.abs(r).max(), 1.0), (nm, err)
        if name.startswith("encoder"):
            assert not a[-1].any(), nm                # the all-pad row


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_3xtf32_sparse_f32_backward_skip_is_bitwise_invisible(rate):
    """In the same model of the f32 sparse backward, the all-ones tile table
    gives the bits of the computed one (causal, dropout on and off): a
    processed tile with no visible pair adds an exact zero partial sum."""
    d, tq = 64, 256
    _, tgt = _packed_segs(2, tq, 23)
    x = [torch.from_numpy(0.5 * _rand((2, 2, tq, d), 50 + i))
         for i in range(4)]
    se = fas.pack_se(torch.tensor(tgt), torch.tensor(tgt))
    vis = fas.compute_block_vis(se, tq, tq, causal=True)
    assert not vis.all()
    sm = 1.0 / np.sqrt(d)
    out, lse = fas.flash_attention_sparse_fwd_plain(*x[:3], se, vis, True,
                                                    sm, rate, 9)
    args = (out, lse, x[3], se)
    skipping = _sparse_bwd_3xtf32(*x[:3], *args, vis, True, sm, rate, 9)
    every = _sparse_bwd_3xtf32(*x[:3], *args, torch.ones_like(vis), True,
                               sm, rate, 9)
    for nm, a, r in zip(("dq", "dk", "dv"), skipping, every):
        assert torch.equal(a, r), nm


def _sparse_fwd_3xtf32(q, k, v, se, vis, causal, sm, rate=0.0, seed=0,
                       scores=mm_3xtf32_groups):
    """out, lse of the f32 block-sparse forwards as their kernels compute
    them: each row walks the visible key tiles of its 64-row tile of the
    table; S in 3xTF32 summed as `scores` sums it (the wide kernel:
    mm_3xtf32_groups; the tuned one, d <= 256: _scores_16, its K chunks
    taken in order above d = 128, so one 16-column partial sum after
    another over the whole head dim); masked scores −1e30 and
    masked p exactly 0; the online softmax with the rescale exactly 1 where
    the running max holds; each tile's P_drop·V in 3xTF32 into a zeroed
    partial sum added to the rescaled O; O times 1 / l at the end. exp is
    exact here (the kernel uses ex2.approx). [B, nh, T, d] f32 tensors."""
    b, nh, tq, d = q.shape
    tk, t_ = k.shape[2], fas.TILE
    mask = fas._mask(se, None, tq, tk, causal)[:, 0]
    keep = (tfa.dropout_keep_mask(seed, rate, b, nh, tq, tk) if rate > 0.0
            else torch.ones(b, nh, tq, tk, dtype=torch.bool))
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    neg = torch.tensor(tfa.NEG_INF)
    tiles = lambda i: slice(i * t_, (i + 1) * t_)
    out = torch.zeros_like(q)
    lse = torch.zeros(b, nh, tq)
    for bi in range(b):
        for iq in range(tq // t_):
            r = tiles(iq)
            m = torch.full((nh, t_, 1), tfa.NEG_INF)
            l = torch.zeros(nh, t_, 1)
            o = torch.zeros(nh, t_, d)
            for kt in range(tk // t_):
                if not vis[bi, iq, kt]:
                    continue
                c = tiles(kt)
                vis_rc = mask[bi, r, c]
                s = torch.where(vis_rc,
                                scores(q[bi, :, r], k[bi, :, c].transpose(
                                    -1, -2)) * sm, neg)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                corr = torch.where(m_new == m, torch.ones(()),
                                   torch.exp(m - m_new))
                p = torch.where(vis_rc, torch.exp(s - m_new), torch.zeros(()))
                l = l * corr + p.sum(-1, keepdim=True)
                m = m_new
                p = torch.where(keep[bi, :, r, c], p * scale, torch.zeros(()))
                o = o * corr + mm_3xtf32(p, v[bi, :, c])
            l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
            out[bi, :, r] = o * (1.0 / l_safe)
            lse[bi, :, r] = (m + torch.log(l_safe)).squeeze(-1)
    return out, lse


def _jax_fwd(q, k, v, nh, q_seg, k_seg, causal):
    """out [B, T, nh·d] and lse [B, nh, Tq] of the JAX package's sparse
    forward (its Pallas kernel where FORCE_PALLAS_INTERPRET is set)."""
    import jax.numpy as jnp

    fa = _jfa()
    d = q.shape[-1] // nh
    qf, kf, vf = (fa._pack_to_folded(jnp.asarray(x), nh) for x in (q, k, v))
    out, lse = fa._flash_sparse_fwd_dispatch(
        qf, kf, vf, fa._pack_se(q_seg, k_seg), None, nh,
        1.0 / np.sqrt(d), causal, 0.0)
    b = q.shape[0]
    return (np.asarray(fa._folded_to_pack(out, b)),
            np.asarray(lse).reshape(b, nh, -1))


@pytest.mark.parametrize("name", list(_FWD_CASES))
def test_3xtf32_products_hold_the_sparse_f32_forward(name):
    """The decision rule of the f32 sparse forward's 3xTF32 design (d <=
    256): its arithmetic, emulated on the CPU (_sparse_fwd_3xtf32 with S in
    16-column partial sums over the head dim, K's chunks in order), against
    the JAX package's _flash_fwd_pallas_sparse in interpret mode, on segment
    rows of reader.pack_by_tokens: out and lse within chip_smoke's f32 TOL
    (2e-5 of max(|ref|, 1)), the all-pad row's out exactly 0 and lse
    exactly -1e30. Then the pair as the card runs it: that out and lse fed
    to the backward's model (_sparse_bwd_3xtf32), dq, dk and dv within the
    same tolerance of the JAX Pallas backward."""
    fa = _jfa()
    q, k, v, dy, q_seg, k_seg, nh, d, causal = _model_case(name)
    tq, tk = q.shape[1], k.shape[1]
    fa.FORCE_PALLAS_INTERPRET = True
    try:
        assert fa._sparse_pallas_ok(tq, tk, d)
        ref_out, ref_lse = _jax_fwd(q, k, v, nh, q_seg, k_seg, causal)
        ref_grads = _jax(q, k, v, nh, q_seg, k_seg, dy, causal)[1:]
    finally:
        fa.FORCE_PALLAS_INTERPRET = False
    heads = lambda x: torch.tensor(x).unflatten(-1, (nh, d)).transpose(1, 2)
    packed = lambda x: x.transpose(1, 2).reshape(x.shape[0], -1,
                                                 nh * d).numpy()
    qh, kh, vh, gh = (heads(x) for x in (q, k, v, dy))
    se = fas.pack_se(torch.tensor(q_seg), torch.tensor(k_seg))
    vis = fas.compute_block_vis(se, tq, tk, causal=causal)
    assert not vis.all(), "the case must skip tiles"
    sm = 1.0 / np.sqrt(d)
    out, lse = _sparse_fwd_3xtf32(qh, kh, vh, se, vis, causal, sm,
                                  scores=_scores_16)
    got = [("out", packed(out), ref_out), ("lse", lse.numpy(), ref_lse)]
    grads = _sparse_bwd_3xtf32(qh, kh, vh, out, lse, gh, se, vis, causal, sm)
    got += [(nm, packed(a), r)
            for nm, a, r in zip(("dq", "dk", "dv"), grads, ref_grads)]
    for nm, a, r in got:
        err = np.abs(a - r).max()
        assert err <= 2e-5 * max(np.abs(r).max(), 1.0), (nm, err)
    if _FWD_CASES[name][3]:                          # the all-pad row
        assert not out[-1].any() and (lse[-1] == -1e30).all()
        assert all(not a[-1].any() for a in grads)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_3xtf32_sparse_f32_forward_skip_is_bitwise_invisible(rate):
    """In the model of the f32 sparse forward (d = 64, causal, packed
    decoder rows), the all-ones tile table gives the bits of the computed
    one, dropout off and on: a processed tile with no visible pair
    rescales by exactly 1 and adds an exact zero partial sum."""
    d, tq = 64, 256
    _, tgt = _packed_segs(2, tq, 23)
    q, k, v = (torch.from_numpy(0.5 * _rand((2, 2, tq, d), 80 + i))
               for i in range(3))
    se = fas.pack_se(torch.tensor(tgt), torch.tensor(tgt))
    vis = fas.compute_block_vis(se, tq, tq, causal=True)
    assert not vis.all()
    sm = 1.0 / np.sqrt(d)
    skipping, every = (_sparse_fwd_3xtf32(q, k, v, se, t, True, sm, rate, 9,
                                          scores=_scores_16)
                       for t in (vis, torch.ones_like(vis)))
    for nm, a, r in zip(("out", "lse"), skipping, every):
        assert torch.equal(a, r), nm


def _wide_sparse_case(d, seed=60):
    """Two rows of pack_by_tokens decoder segments at T = 128, nh = 1, head
    dim d: [B, nh, T, d] q, k, v, dO and the causal tables."""
    _, tgt = _packed_segs(2, 128, 25)
    x = [torch.from_numpy(0.5 * _rand((2, 1, 128, d), seed + i))
         for i in range(4)]
    se = fas.pack_se(torch.tensor(tgt), torch.tensor(tgt))
    return x, se, fas.compute_block_vis(se, 128, 128, causal=True)


@pytest.mark.parametrize("d", [320, 512])
def test_3xtf32_wide_products_hold_the_sparse_f32_kernels(d):
    """The decision rule of the f32 wide block-sparse kernels (d >= 320):
    the forward (_sparse_fwd_3xtf32) and the backward (_sparse_bwd_3xtf32
    with S and dP summed as mm_3xtf32_groups sums them), causal with dropout
    0.1 on packed decoder rows, within a quarter of the card's f32
    tolerance (2e-5) of the plain f32 versions: out, lse, dq, dk, dv."""
    tol = 2e-5 / 4
    (q, k, v, g), se, vis = _wide_sparse_case(d)
    assert not vis.all(), "the case must skip tiles"
    sm = 1.0 / np.sqrt(d)
    want = fas.flash_attention_sparse_fwd_plain(q, k, v, se, vis, True, sm,
                                                0.1, 9)
    got = _sparse_fwd_3xtf32(q, k, v, se, vis, True, sm, 0.1, 9)
    for nm, a, w in zip(("out", "lse"), got, want):
        torch.testing.assert_close(a, w, rtol=tol, atol=tol, msg=nm)
    out, lse = want
    want = fas.flash_attention_sparse_bwd_plain(q, k, v, out, lse, g, se,
                                                vis, True, sm, 0.1, 9)
    got = _sparse_bwd_3xtf32(q, k, v, out, lse, g, se, vis, True, sm, 0.1,
                             9, scores=mm_3xtf32_groups)
    for nm, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, w, rtol=tol, atol=tol, msg=nm)


def test_3xtf32_wide_sparse_skip_is_bitwise_invisible():
    """In the models of the f32 wide block-sparse kernels, the all-ones tile
    table gives the bits of the computed one (causal, dropout 0.1): a
    processed tile with no visible pair rescales by exactly 1 and adds an
    exact zero partial sum, forward and backward."""
    (q, k, v, g), se, vis = _wide_sparse_case(320, 70)
    assert not vis.all()
    sm = 1.0 / np.sqrt(320)
    ones = torch.ones_like(vis)
    fwd = [_sparse_fwd_3xtf32(q, k, v, se, t, True, sm, 0.1, 9)
           for t in (vis, ones)]
    for nm, a, r in zip(("out", "lse"), *fwd):
        assert torch.equal(a, r), nm
    out, lse = fwd[0]
    bwd = [_sparse_bwd_3xtf32(q, k, v, out, lse, g, se, t, True, sm, 0.1, 9,
                              scores=mm_3xtf32_groups) for t in (vis, ones)]
    for nm, a, r in zip(("dq", "dk", "dv"), *bwd):
        assert torch.equal(a, r), nm


def test_bf16_forward_reads_packed_heads_and_se_in_place():
    """The bf16 forward's TMA maps read the [B, nh, T, d] head views of a
    packed [B, T, nh·d] projection and se's [1, 1, B, Tq] view in place, as
    flash_attention_packed_sparse hands them over: no copy; a tensor whose
    last dim is not contiguous is copied, never refused."""
    b, t, nh, d = 2, 128, 4, 64
    qkv = torch.zeros(b, t, 3 * nh * d, dtype=torch.bfloat16)
    q, k, v = (x.unflatten(-1, (nh, d)).transpose(1, 2)
               for x in qkv.split(nh * d, dim=-1))
    seg = torch.tensor(_uneven_segs(b, t, np.random.RandomState(8)))
    se = fas.pack_se(seg, seg)
    ts, descs = fas._fwd_bf16_tensors(q, k, v, se)
    assert [x.data_ptr() for x in ts] == [x.data_ptr() for x in (q, k, v,
                                                                 se)]
    assert descs[0][1:] == [d, t, nh, b, 3 * nh * d * 2, d * 2,
                            t * 3 * nh * d * 2]
    assert descs[3] == [se.data_ptr(), t, b, 1, 1, t * 4, b * t * 4,
                        b * t * 4]
    qt = torch.zeros(b, nh, d, t, dtype=torch.bfloat16).transpose(2, 3)
    ts, descs = fas._fwd_bf16_tensors(qt, k, v, se)
    assert ts[0].data_ptr() != qt.data_ptr() and ts[0].is_contiguous()
    assert torch.equal(ts[0], qt) and descs[0] == tfa._tma_desc(ts[0])


@pytest.mark.parametrize("d", [320, 512])
def test_wide_bf16_forward_matches_jax_pallas_interpret(d):
    """The bf16 forward at d = 320 and 512 (the wide kernel's plain version
    on the CPU) against the JAX package's Pallas forward in interpret mode
    on the same bf16 inputs, on two packed NMT rows (T = 128): encoder
    self, decoder self (causal) and cross; within rtol = atol = 1e-2 (both
    round P and the output to bf16, at different points; half a bf16 ulp at
    |x| < 2 is below 4e-3)."""
    import jax.numpy as jnp

    fa = _jfa()
    b, t, nh = 2, 128, 1
    src, tgt = _packed_segs(b, t, 4)
    q, k, v = (0.5 * _rand((b, t, nh * d), 60 + i) for i in range(3))
    fa.FORCE_PALLAS_INTERPRET = True
    try:
        assert fa._sparse_pallas_ok(t, t, d)
        for qs, ks, causal in ((src, src, False), (tgt, tgt, True),
                               (tgt, src, False)):
            want = fa.flash_attention_packed_sparse(
                *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), nh, qs,
                ks, causal=causal)
            got = fas.flash_attention_packed_sparse(
                *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), nh,
                torch.tensor(qs), torch.tensor(ks), causal=causal)
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want).astype(np.float32),
                                       rtol=1e-2, atol=1e-2, err_msg=causal)
    finally:
        fa.FORCE_PALLAS_INTERPRET = False


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")


def _cuda_case(b, t, nh, d, dtype, seed, causal=False):
    """Packed [B, nh, T, d] q, k, v, dO views on the card with a real
    packed-segment descriptor and tile table."""
    g = torch.Generator("cuda").manual_seed(seed)
    seg = torch.tensor(_uneven_segs(b, t, np.random.RandomState(seed),
                                    max_seg=3), device="cuda")
    se = fas.pack_se(seg, seg)
    vis = fas.compute_block_vis(se, t, t, causal=causal)
    q, k, v, dout = (torch.randn(b, t, nh * d, generator=g, device="cuda")
                     .to(dtype).unflatten(-1, (nh, d)).transpose(1, 2)
                     for _ in range(4))
    return q, k, v, dout, se, vis


def _close(got, want, tol):
    for a, w in zip(got, want):
        err = (a.float() - w.float()).abs().max().item()
        assert err <= tol * max(w.float().abs().max().item(), 1.0), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fwd_tol,bwd_tol", [
    (torch.float32, 2e-5, 2e-5), (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("d,causal,rate", [
    (64, False, 0.0), (64, True, 0.1), (128, False, 0.1), (192, True, 0.0),
    (256, False, 0.1), (320, True, 0.1), (320, False, 0.0), (512, True, 0.0),
    (512, False, 0.1)])
def test_cuda_kernels_match_plain(dtype, fwd_tol, bwd_tol, d, causal, rate):
    """The sparse kernels against their plain versions on the card at
    every head dim (the wide kernels from d = 320), with dropout from the
    same seed; the backward is bitwise repeatable and an all-ones tile
    table changes no bit."""
    _cuda_or_skip()
    q, k, v, dout, se, vis = _cuda_case(2, 256, 2, d, dtype, 3, causal)
    fns = (fas.flash_attention_sparse_fwd, fas.flash_attention_sparse_bwd)
    before = [(f.launches, f.wide_launches) for f in fns]
    out, lse = fas.flash_attention_sparse_fwd(q, k, v, se, vis, causal, None,
                                              rate, 7)
    got = fas.flash_attention_sparse_bwd(q, k, v, out, lse, dout, se, vis,
                                         causal, None, rate, 7)
    wide = int(d not in tfa.HEAD_DIMS)
    assert [(f.launches, f.wide_launches) for f in fns] == [
        (n + 1, w + wide) for n, w in before]
    ref = fas.flash_attention_sparse_fwd_plain(q, k, v, se, vis, causal,
                                               None, rate, 7)
    want = fas.flash_attention_sparse_bwd_plain(q, k, v, out, lse, dout, se,
                                                vis, causal, None, rate, 7)
    _close((out, lse), ref, fwd_tol)
    _close(got, want, bwd_tol)
    again = fas.flash_attention_sparse_bwd(q, k, v, out, lse, dout, se, vis,
                                           causal, None, rate, 7)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ones = torch.ones_like(vis)
    out1, lse1 = fas.flash_attention_sparse_fwd(q, k, v, se, ones, causal,
                                                None, rate, 7)
    got1 = fas.flash_attention_sparse_bwd(q, k, v, out1, lse1, dout, se, ones,
                                          causal, None, rate, 7)
    assert all(torch.equal(a, b) for a, b in zip((out, lse) + tuple(got),
                                                 (out1, lse1) + tuple(got1)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_cuda_bf16_forward_entry_cross_attention(d):
    """The bf16 forward's C entry (flash_attention_sparse_fwd_bf16, wgmma
    over TMA maps) through the wrapper, at cross attention Tq = 192 != Tk =
    256 on packed head views with dropout: one launch, out and lse within
    2e-2 of the plain version, pad queries exactly 0 and -1e30."""
    _cuda_or_skip()
    b, nh, tq, tk = 2, 2, 192, 256
    g = torch.Generator("cuda").manual_seed(d)
    rng = np.random.RandomState(d)
    q_seg = torch.tensor(_uneven_segs(b, tq, rng, max_seg=3), device="cuda")
    k_seg = torch.tensor(_uneven_segs(b, tk, rng, max_seg=3), device="cuda")
    se = fas.pack_se(q_seg, k_seg)
    vis = fas.compute_block_vis(se, tq, tk)
    q = (torch.randn(b, tq, nh * d, generator=g, device="cuda")
         .to(torch.bfloat16).unflatten(-1, (nh, d)).transpose(1, 2))
    k, v = (torch.randn(b, tk, nh * d, generator=g, device="cuda")
            .to(torch.bfloat16).unflatten(-1, (nh, d)).transpose(1, 2)
            for _ in range(2))
    before = fas.flash_attention_sparse_fwd.launches
    out, lse = fas.flash_attention_sparse_fwd(q, k, v, se, vis, False, None,
                                              0.1, 5)
    assert fas.flash_attention_sparse_fwd.launches == before + 1
    _close((out, lse), fas.flash_attention_sparse_fwd_plain(
        q, k, v, se, vis, False, None, 0.1, 5), 2e-2)
    assert not out[0].any() and (lse[0] == -1e30).all()   # row 0: all pad


@pytest.mark.cuda
@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("t", [128, 256])
def test_cuda_wide_bf16_forward_entry(d, t):
    """The bf16 wide forward (flash_attention_wide_fwd_bf16) through the
    sparse wrapper on NMT-like packed rows, B=4, nh=2: encoder self,
    decoder self (causal, dropout) and cross (dropout), out and lse within
    2e-2 of the plain version; one wide launch a call; an all-ones tile
    table changes no bit (dropout on)."""
    _cuda_or_skip()
    b, nh = 4, 2
    g = torch.Generator("cuda").manual_seed(d + t)
    src_np, tgt_np = _packed_segs(b, t, 7)
    src, tgt = (torch.tensor(x, device="cuda") for x in (src_np, tgt_np))
    q, k, v = (torch.randn(b, t, nh * d, generator=g, device="cuda")
               .to(torch.bfloat16).unflatten(-1, (nh, d)).transpose(1, 2)
               for _ in range(3))
    fwd = fas.flash_attention_sparse_fwd
    for (qs, ks), causal, rate in (((src, src), False, 0.0),
                                   ((tgt, tgt), True, 0.1),
                                   ((tgt, src), False, 0.1)):
        se = fas.pack_se(qs, ks)
        vis = fas.compute_block_vis(se, t, t, causal=causal)
        before = (fwd.launches, fwd.wide_launches, fwd.plain_on_cuda)
        out, lse = fwd(q, k, v, se, vis, causal, None, rate, 5)
        assert (fwd.launches, fwd.wide_launches, fwd.plain_on_cuda) == (
            before[0] + 1, before[1] + 1, before[2])
        _close((out, lse), fas.flash_attention_sparse_fwd_plain(
            q, k, v, se, vis, causal, None, rate, 5), 2e-2)
        ones = fwd(q, k, v, se, torch.ones_like(vis), causal, None, rate, 5)
        assert torch.equal(out, ones[0]) and torch.equal(lse, ones[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_cuda_f32_backward_entry_reads_lse_rows_by_pitch(d):
    """The f32 backward's C entry (flash_attention_sparse_bwd, 3xTF32) with
    lse rows Tq + 4 floats apart (a view of a wider buffer): the pitch
    reaches the kernel; dq, dk, dv within 2e-5 of the plain version and
    bitwise repeatable, causal with dropout."""
    _cuda_or_skip()
    q, k, v, dout, se, vis = _cuda_case(2, 256, 2, d, torch.float32, 6,
                                        causal=True)
    out, lse = fas.flash_attention_sparse_fwd(q, k, v, se, vis, True, None,
                                              0.1, 3)
    wide = torch.full((2 * 2, 256 + 4), float("nan"), device="cuda")
    wide[:, :256] = lse.reshape(4, 256)
    lse_p = wide[:, :256].view(2, 2, 256)
    got = fas.flash_attention_sparse_bwd(q, k, v, out, lse_p, dout, se, vis,
                                         True, None, 0.1, 3)
    _close(got, fas.flash_attention_sparse_bwd_plain(
        q, k, v, out, lse, dout, se, vis, True, None, 0.1, 3), 2e-5)
    again = fas.flash_attention_sparse_bwd(q, k, v, out, lse_p, dout, se,
                                           vis, True, None, 0.1, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_cuda_f32_forward_entry(d):
    """The f32 forward's C entry (flash_attention_sparse_fwd, 3xTF32) at
    cross attention Tq = 192 != Tk = 256 on packed head views with dropout:
    its launch has one CTA per (64-wide output chunk above d = 128, q tile,
    b·h); one launch a call; out and lse within 2e-5 of the plain version;
    pad queries exactly 0 and -1e30; every chunk CTA forms the softmax (and
    so the lse chunk 0 writes) bit for bit: with V's 64-wide chunks copies
    of one another, out's chunks are bitwise equal."""
    _cuda_or_skip()
    b, nh, tq, tk = 2, 2, 192, 256
    g = torch.Generator("cuda").manual_seed(d)
    rng = np.random.RandomState(d)
    q_seg = torch.tensor(_uneven_segs(b, tq, rng, max_seg=3), device="cuda")
    k_seg = torch.tensor(_uneven_segs(b, tk, rng, max_seg=3), device="cuda")
    se = fas.pack_se(q_seg, k_seg)
    vis = fas.compute_block_vis(se, tq, tk)
    q = (torch.randn(b, tq, nh * d, generator=g, device="cuda")
         .unflatten(-1, (nh, d)).transpose(1, 2))
    k = (torch.randn(b, tk, nh * d, generator=g, device="cuda")
         .unflatten(-1, (nh, d)).transpose(1, 2))
    v = (torch.randn(b, tk, nh, 64, generator=g, device="cuda")
         .repeat(1, 1, 1, d // 64).transpose(1, 2))
    chunks = d // 64 if d > 128 else 1
    assert fas._lib().flash_attention_sparse_fwd_ctas(b, nh, tq, d) == (
        b * nh * (tq // 64) * chunks)
    before = fas.flash_attention_sparse_fwd.launches
    out, lse = fas.flash_attention_sparse_fwd(q, k, v, se, vis, False, None,
                                              0.1, 5)
    assert fas.flash_attention_sparse_fwd.launches == before + 1
    _close((out, lse), fas.flash_attention_sparse_fwd_plain(
        q, k, v, se, vis, False, None, 0.1, 5), 2e-5)
    assert not out[0].any() and (lse[0] == -1e30).all()   # row 0: all pad
    for c in range(1, d // 64):
        assert torch.equal(out[..., 64 * c:64 * (c + 1)], out[..., :64]), c


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(96, 64), (128, 32)])
def test_cuda_plain_route_is_counted(t, d):
    """T = 96 and d = 32 on the card: the plain versions, counted in
    .plain_on_cuda, no launch."""
    _cuda_or_skip()
    q, k, v, dout, se, vis = _cuda_case(2, t, 2, d, torch.bfloat16, 4)
    before = [(f.launches, f.plain_on_cuda) for f in (
        fas.flash_attention_sparse_fwd, fas.flash_attention_sparse_bwd)]
    out, lse = fas.flash_attention_sparse_fwd(q, k, v, se, vis)
    fas.flash_attention_sparse_bwd(q, k, v, out, lse, dout, se, vis)
    after = [(f.launches, f.plain_on_cuda) for f in (
        fas.flash_attention_sparse_fwd, fas.flash_attention_sparse_bwd)]
    assert after == [(n, p + 1) for n, p in before]


@pytest.mark.cuda
def test_cuda_grid_past_65535_heads():
    """B·nh = 65,600 launches the forward and both backward kernels on the
    flat grid and agrees with the plain versions."""
    _cuda_or_skip()
    q, k, v, dout, se, vis = _cuda_case(4100, 64, 16, 64, torch.bfloat16, 5)
    out, lse = fas.flash_attention_sparse_fwd(q, k, v, se, vis)
    _close((out, lse), fas.flash_attention_sparse_fwd_plain(q, k, v, se, vis),
           2e-2)
    _close(fas.flash_attention_sparse_bwd(q, k, v, out, lse, dout, se, vis),
           fas.flash_attention_sparse_bwd_plain(q, k, v, out, lse, dout, se,
                                                vis), 1e-2)


def test_kernel_wrappers_route_by_device():
    """A CPU tensor takes the plain version (bitwise the same result); a
    tensor on a device without a kernel raises; nothing counts a launch."""
    b, t, nh, d = 2, 64, 2, 64
    seg = torch.tensor(_uneven_segs(b, t, np.random.RandomState(3)))
    se = fas.pack_se(seg, seg)
    vis = fas.compute_block_vis(se, t, t)
    q, k, v = (torch.tensor(_rand((b, nh, t, d), i)) for i in range(3))
    before = (fas.flash_attention_sparse_fwd.launches,
              fas.flash_attention_sparse_bwd.launches)
    out, lse = fas.flash_attention_sparse_fwd(q, k, v, se, vis)
    pout, plse = fas.flash_attention_sparse_fwd_plain(q, k, v, se, vis)
    torch.testing.assert_close(out, pout, rtol=0, atol=0)
    # pad query rows (row 0 is all pad): out 0, lse -1e30
    assert not out[0].any() and (lse[0] == -1e30).all()
    grads = fas.flash_attention_sparse_bwd(q, k, v, out, lse, q, se, vis)
    assert all(not g[0].any() for g in grads)
    assert (fas.flash_attention_sparse_fwd.launches,
            fas.flash_attention_sparse_bwd.launches) == before
    meta = [x.to("meta") for x in (q, k, v, se, vis)]
    with pytest.raises(ValueError, match="no kernel for device"):
        fas.flash_attention_sparse_fwd(*meta)


def test_sparse_op_and_layer():
    """flash_attention_sparse as a program op: the port's layer and op
    match the direct call, and JAX's op on the same inputs."""
    import paddle_tpu as jfluid
    from paddle_tpu.core import unique_name as jnames

    b, t, nh, d = 2, 32, 2, 8
    seg = _uneven_segs(b, t, np.random.RandomState(5), max_seg=2)
    q, k, v = (_rand((b, t, nh * d), i) for i in range(3))
    feed = {"q": q, "k": k, "v": v, "q_seg": seg, "k_seg": seg}
    got = []
    for fluid, place, guard in (
            (tfluid, tfluid.CPUPlace(), tfluid.unique_name.guard),
            (jfluid, jfluid.TPUPlace(), jnames.guard)):
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            qv, kv, vv = (fluid.layers.data(n, [t, nh * d]) for n in "qkv")
            qs = fluid.layers.data("q_seg", [t], dtype="int32")
            ks = fluid.layers.data("k_seg", [t], dtype="int32")
            out = fluid.layers.flash_attention_sparse(qv, kv, vv, nh, qs, ks,
                                                      causal=True)
        exe = fluid.Executor(place)
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            got.append(np.asarray(exe.run(main, feed=feed,
                                          fetch_list=[out])[0]))
    direct = fas.flash_attention_packed_sparse(
        *(torch.tensor(x) for x in (q, k, v)), nh, torch.tensor(seg),
        torch.tensor(seg), causal=True)
    np.testing.assert_array_equal(got[0], direct.numpy())
    np.testing.assert_allclose(got[0], got[1], **FWD_TOL)


@pytest.mark.parametrize("d", [320, 512])
def test_wide_bf16_backward_matches_jax_pallas_interpret(d):
    """The bf16 backward at d = 320 and 512 (the wide kernel's plain
    version on the CPU) against jax.vjp through the JAX package's Pallas
    kernels in interpret mode, on the same bf16 inputs and cotangent, on
    two packed NMT rows (T = 128), decoder self (causal): dq, dk and dv
    each within 1e-2 of its largest |value| (both round P, dS and dO to
    bf16 before their products, at different points); the pad rows'
    gradients exactly 0."""
    import jax
    import jax.numpy as jnp

    fa = _jfa()
    b, t, nh = 2, 128, 1
    _, tgt = _packed_segs(b, t, 4)
    q, k, v, dy = (0.5 * _rand((b, t, nh * d), 64 + i) for i in range(4))
    fa.FORCE_PALLAS_INTERPRET = True
    try:
        assert fa._sparse_pallas_ok(t, t, d)
        _, vjp = jax.vjp(
            lambda *a: fa.flash_attention_packed_sparse(*a, nh, tgt, tgt,
                                                        causal=True),
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
        want = vjp(jnp.asarray(dy, jnp.bfloat16))
    finally:
        fa.FORCE_PALLAS_INTERPRET = False
    targs = [torch.from_numpy(x).bfloat16().requires_grad_()
             for x in (q, k, v)]
    out = fas.flash_attention_packed_sparse(
        *targs, nh, torch.tensor(tgt), torch.tensor(tgt), causal=True)
    got = torch.autograd.grad(out, targs, torch.from_numpy(dy).bfloat16())
    pad = tgt == 0
    assert pad.any()
    for a, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16, name
        a, w = a.float().numpy(), np.asarray(w).astype(np.float32)
        assert np.abs(a - w).max() <= 1e-2 * np.abs(w).max(), name
        assert not a[pad].any(), name
