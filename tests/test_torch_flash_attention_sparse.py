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
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import flash_attention_sparse as fas

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
                                  "tk_overflow"])
def test_value_errors(case):
    """Every ValueError of JAX's flash_attention_packed_sparse, and the
    16-bit descriptor overflow of _pack_se."""
    b, t, nh, d = 2, 16, 2, 8
    x = torch.zeros(b, t, nh * d)
    seg = torch.ones(b, t, dtype=torch.int32)
    call = dict(q=x, k=x, v=x, num_heads=nh, q_seg=seg, k_seg=seg)
    match = {"heads": "not divisible", "rate_high": "dropout_rate",
             "rate_negative": "dropout_rate", "no_seed": "requires a seed",
             "causal_cross": "causal requires", "seg_shape": "seg shapes",
             "tk_overflow": "overflows"}[case]
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
    else:
        long = torch.ones(b, 1 << 15, dtype=torch.int32)
        with pytest.raises(ValueError, match=match):
            fas.pack_se(seg, long)
        return
    with pytest.raises(ValueError, match=match):
        fas.flash_attention_packed_sparse(**call)


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
