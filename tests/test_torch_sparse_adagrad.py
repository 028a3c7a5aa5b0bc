"""The port's packed rows, duplicate merge and sparse-Adagrad / row
gather / row scatter kernels (rows 12–14,
``paddle_tpu_torch/ops/kernels/sparse_adagrad.py``) against the JAX
package, on the CPU.

On the CPU the wrappers run the kernels' plain versions; the JAX side runs
its Pallas kernels under the interpreter (``FORCE_PALLAS_INTERPRET``).
``pack_rows``/``unpack_rows``, ``uniq_merge`` and the row kernels agree bit
for bit. Row 12's plain version rounds after every operation: it is bit
for bit the JAX package's unfused update run op by op (eager jnp), and it
leaves untouched rows and zeroes spare lanes exactly as the interpreted
Pallas kernel does. Against that kernel, which XLA compiles as one
function and may contract ``G + u*u`` into an FMA and divide less than
exactly, the accumulator agrees within 1 ULP (the JAX package's own bar,
``tests/test_sparse_adagrad_kernel.py``) and the parameter within 2 ULP of
the larger of the new parameter and the step ``lr*u/(sqrt(G)+eps)``: where
the step nearly cancels the parameter, a 1-ULP difference of the step is
many ULP of the result. After three chained steps: 3 ULP and 4 units."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import deferred_rows as jdr
from paddle_tpu.ops.pallas_kernels import sparse_adagrad as jfsa
from paddle_tpu_torch.ops import deferred_rows as dr
from paddle_tpu_torch.ops.kernels import sparse_adagrad as fsa

torch.set_num_threads(1)


@pytest.fixture
def interpret_kernel():
    old = jfsa.FORCE_PALLAS_INTERPRET
    jfsa.FORCE_PALLAS_INTERPRET = True
    yield
    jfsa.FORCE_PALLAS_INTERPRET = old


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _np(t):
    return dr.i16(t).numpy().view(np.uint16) if t.dtype == torch.uint16 \
        else t.numpy()


# -- packed rows ---------------------------------------------------------------

def test_pack_unpack_bitwise_equal_to_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(6, 17).astype(np.float32)
    x.flat[:8] = [-0.0, 0.0, 1e-40, -1e-42, 3.4e38, -3.4e38, np.inf, -1.5]
    for lanes in (128, 34):
        want = np.asarray(jdr.pack_rows(jnp.asarray(x), lanes))
        got = _np(dr.pack_rows(_t(x), lanes))
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
        back = dr.unpack_rows(_t(want), 17).numpy()
        np.testing.assert_array_equal(back.view(np.int32), x.view(np.int32))
    with pytest.raises(ValueError, match="lanes"):
        dr.pack_rows(_t(np.zeros((1, 65), np.float32)))


# -- uniq_merge ------------------------------------------------------------------

def _both_merges(ids, rows, r):
    want = [np.asarray(a) for a in jdr.uniq_merge(
        jnp.asarray(ids.astype(np.int32)), jnp.asarray(rows), r)]
    got = [a.numpy() for a in dr.uniq_merge(_t(ids.astype(np.int64)),
                                            _t(rows), r)]
    return got, want


@pytest.mark.parametrize("case", ["random", "all_duplicates", "boundary",
                                  "empty"])
def test_uniq_merge_equals_jax(case):
    """Twins of test_sparse_row_updates.py:352-410: uids, per-id sums (bit
    for bit: both sum duplicates one after another in occurrence order)
    and the representative positions."""
    rng = np.random.RandomState(2)
    ids = {"random": rng.randint(0, 9, 40),
           "all_duplicates": np.full(6, 17),
           "boundary": np.array([17, 0, 49, 17, 16, 0, 17]),
           "empty": np.zeros(0, np.int64)}[case]
    rows = rng.randn(ids.size, 4).astype(np.float32)
    (uids, utot, rep), (juids, jutot, jrep) = _both_merges(ids, rows, 48)
    np.testing.assert_array_equal(uids, juids.astype(np.int64))
    assert (uids[np.unique(ids).size:] == dr.SENTINEL).all()
    np.testing.assert_array_equal(utot.view(np.int32), jutot.view(np.int32))
    n = np.unique(ids).size
    np.testing.assert_array_equal(rep[:n], jrep[:n])
    for k, u in enumerate(np.unique(ids)):
        assert ids[rep[k]] == u


def test_uniq_merge_capacity_overflow_raises():
    with pytest.raises(ValueError, match="rows_per_step"):
        dr.uniq_merge(torch.arange(9), torch.zeros((9, 4)), 8)


# -- row 12 ------------------------------------------------------------------

def _random_case(seed, v, vis, q):
    """A packed table (accumulator columns >= 0) and a step of gradient rows
    (duplicates expected for q > v or by chance)."""
    rng = np.random.RandomState(seed)
    dense = rng.randn(v, 2 * vis).astype(np.float32)
    dense[:, vis:] = np.abs(dense[:, vis:])
    table = np.array(jdr.pack_rows(jnp.asarray(dense)))
    ids = rng.randint(0, v, size=q)
    grows = rng.randn(q, vis).astype(np.float32)
    return table, ids, grows


def _jax_fused(table, ids, grows, r, vis, lr=0.05, eps=1e-6):
    uids, utot, _ = jdr.uniq_merge(jnp.asarray(ids.astype(np.int32)),
                                   jnp.asarray(grows), r)
    return np.asarray(jfsa.fused_adagrad_update(
        jnp.asarray(table), uids, utot, lr, vis=vis, eps=eps))


def _port_fused(table, ids, grows, r, vis, lr=0.05, eps=1e-6):
    t = _t(table)
    uids, utot, _ = dr.uniq_merge(_t(ids.astype(np.int64)), _t(grows), r)
    out = fsa.fused_adagrad_update(t, uids, utot, lr, vis=vis, eps=eps)
    assert out is t  # updated in place
    return _np(out)


def _jax_unfused_eager(table, ids, grows, r, vis, lr=0.05, eps=1e-6):
    """The JAX package's unfused packed-Adagrad update, op by op (no jit):
    each jnp op rounds on its own, as each torch op does."""
    uids, utot, _ = jdr.uniq_merge(jnp.asarray(ids.astype(np.int32)),
                                   jnp.asarray(grows), r)
    cur = jdr.unpack_rows(jnp.asarray(table), 2 * vis)[
        jnp.clip(uids, 0, table.shape[0] - 1)]
    g_new = cur[:, vis:] + utot * utot
    p_new = cur[:, :vis] - lr * utot / (jnp.sqrt(g_new) + eps)
    out = table.copy()
    n = int((np.asarray(uids) != jdr.SENTINEL).sum())
    rows = np.asarray(jdr.pack_rows(jnp.concatenate([p_new, g_new], -1)))
    out[np.asarray(uids)[:n]] = rows[:n]
    return out


def _assert_tables_exact(a, b, orig, vis, touched, max_ulp=1, max_units=2):
    """a: the port's table, b: the JAX kernel's, orig: before the step(s)."""
    untouched = np.setdiff1d(np.arange(a.shape[0]), touched)
    np.testing.assert_array_equal(a[untouched], b[untouched])
    fa = a[touched][:, :4 * vis].copy().view(np.float32)
    fb = b[touched][:, :4 * vis].copy().view(np.float32)
    ulp = np.abs(fa[:, vis:].view(np.int32).astype(np.int64)
                 - fb[:, vis:].view(np.int32))
    assert ulp.max(initial=0) <= max_ulp, f"G: max ULP {ulp.max()}"
    p_old = orig[touched][:, :4 * vis].copy().view(np.float32)[:, :vis]
    step = np.abs(p_old.astype(np.float64) - fa[:, :vis]).astype(np.float32)
    unit = np.maximum(np.spacing(np.abs(fa[:, :vis])), np.spacing(step))
    units = np.abs(fa[:, :vis].astype(np.float64) - fb[:, :vis]) / unit
    assert units.max(initial=0) <= max_units, f"p: {units.max()} units"
    np.testing.assert_array_equal(a[touched][:, 4 * vis:],
                                  b[touched][:, 4 * vis:])
    assert not a[touched][:, 4 * vis:].any()  # spare lanes written zero


@pytest.mark.parametrize("seed,v,vis,q,r", [
    (0, 37, 5, 24, 32),     # duplicates + sentinel tail
    (1, 64, 17, 64, 80),    # deepfm-width rows (vis=17)
    (2, 16, 32, 40, 48),    # widest supported payload (4*32 == 128 lanes)
    (3, 128, 4, 8, 8),      # r == q, mostly unique
    (4, 5, 3, 50, 64),      # tiny vocab — heavy duplication
])
def test_fused_update_matches_jax_kernel(interpret_kernel, seed, v, vis, q,
                                         r):
    table, ids, grows = _random_case(seed, v, vis, q)
    # nonzero spare lanes, so the zeroing is seen
    table[:, 4 * vis:] = 7
    ours = _port_fused(table, ids, grows, r, vis)
    np.testing.assert_array_equal(
        ours, _jax_unfused_eager(table, ids, grows, r, vis))
    _assert_tables_exact(ours, _jax_fused(table, ids, grows, r, vis), table,
                         vis, touched=np.unique(ids))


def test_fused_sequential_steps_stay_exact(interpret_kernel):
    v, vis, q, r = 29, 6, 18, 24
    table0 = table_j = table_p = _random_case(7, v, vis, q)[0]
    rng = np.random.RandomState(8)
    touched = []
    for _ in range(3):
        ids = rng.randint(0, v, size=q)
        grows = rng.randn(q, vis).astype(np.float32)
        table_j = _jax_fused(table_j, ids, grows, r, vis)
        table_p = _port_fused(table_p, ids, grows, r, vis)
        touched.append(ids)
    _assert_tables_exact(table_p, table_j, table0, vis,
                         touched=np.unique(np.concatenate(touched)),
                         max_ulp=3, max_units=4)


def test_all_sentinel_slots_leave_table_untouched():
    v, vis, r = 11, 4, 16
    table = _random_case(9, v, vis, 4)[0]
    t = _t(table)
    fsa.fused_adagrad_update(t, torch.full((r,), dr.SENTINEL),
                             torch.zeros((r, vis)), 0.1, vis=vis, eps=1e-6)
    np.testing.assert_array_equal(_np(t), table)


def test_gates_and_shape_errors(monkeypatch):
    assert fsa.supports(32) and not fsa.supports(33)
    assert fsa.enabled(17) and fsa.rows_enabled()
    monkeypatch.setenv("PDTPU_FUSED_SPARSE", "0")
    assert not fsa.enabled(17) and not fsa.rows_enabled()
    t = _t(np.zeros((8, 128), np.uint16))
    with pytest.raises(ValueError, match="packed row"):
        fsa.fused_adagrad_update(t, torch.zeros(4, dtype=torch.int64),
                                 torch.zeros((4, 33)), 0.1, vis=33, eps=1e-6)
    with pytest.raises(TypeError, match="uint16"):
        fsa.fused_row_gather(torch.zeros((4, 128)), torch.zeros(2).long())


# -- rows 13 and 14 -----------------------------------------------------------

def test_row_gather_bitwise_equal_to_jax(interpret_kernel):
    table = np.random.RandomState(0).randint(
        0, 2 ** 16, (10, 128)).astype(np.uint16)
    # duplicates allowed on the read path; the tail repeats the last slot
    slots = np.array([3, 3, 0, 9, 9, 9, 9, 9])
    want = np.asarray(jfsa.fused_row_gather(jnp.asarray(table),
                                            jnp.asarray(slots, jnp.int32)))
    got = _np(fsa.fused_row_gather(_t(table), _t(slots)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table[slots])


def test_row_scatter_bitwise_equal_to_jax(interpret_kernel):
    rng = np.random.RandomState(1)
    table = rng.randint(0, 2 ** 16, (10, 128)).astype(np.uint16)
    rows = rng.randint(0, 2 ** 16, (4, 128)).astype(np.uint16)
    # distinct prefix [7, 2, 5], padded by repeating the last (slot, src)
    slots, src = np.array([7, 2, 5, 5]), np.array([0, 1, 2, 2])
    want = np.asarray(jfsa.fused_row_scatter(
        jnp.asarray(table), jnp.asarray(slots, jnp.int32), jnp.asarray(rows),
        jnp.asarray(src, jnp.int32)))
    t = _t(table)
    out = fsa.fused_row_scatter(t, _t(slots), _t(rows), _t(src))
    assert out is t
    np.testing.assert_array_equal(_np(t), want)
    expect = table.copy()
    expect[[7, 2, 5]] = rows[[0, 1, 2]]
    np.testing.assert_array_equal(_np(t), expect)


@pytest.mark.parametrize("kernel", ["adagrad", "gather", "scatter"])
def test_out_of_range_indices(kernel):
    """The one contract for indices out of range, kept alike by the kernels
    on the card: row 12 skips a uid outside [0, V) as it skips SENTINEL;
    rows 13–14 clamp slots into [0, V) and src into [0, len(rows))."""
    rng = np.random.RandomState(4)
    v, vis = 10, 4
    table = _random_case(4, v, vis, 3)[0]
    if kernel == "adagrad":
        utot = torch.from_numpy(rng.randn(6, vis).astype(np.float32))
        bad = _t(np.array([-3, 2, 5, v, v + 5, dr.SENTINEL]))
        good = _t(np.array([dr.SENTINEL, 2, 5] + [dr.SENTINEL] * 3))
        got, want = _t(table), _t(table)
        fsa.fused_adagrad_update(got, bad, utot, 0.1, vis=vis, eps=1e-6)
        fsa.fused_adagrad_update(want, good, utot, 0.1, vis=vis, eps=1e-6)
        np.testing.assert_array_equal(_np(got), _np(want))
        changed = np.flatnonzero((_np(got) != table).any(axis=1))
        assert changed.tolist() == [2, 5]
    elif kernel == "gather":
        slots = np.array([-2, 4, v + 3])
        got = _np(fsa.fused_row_gather(_t(table), _t(slots)))
        np.testing.assert_array_equal(got, table[[0, 4, v - 1]])
    else:
        rows = rng.randint(0, 2 ** 16, (2, 128)).astype(np.uint16)
        t = _t(table)
        fsa.fused_row_scatter(t, _t(np.array([-1, v + 2])), _t(rows),
                              _t(np.array([-4, 7])))
        expect = table.copy()
        expect[[0, v - 1]] = rows[[0, 1]]
        np.testing.assert_array_equal(_np(t), expect)
        with pytest.raises(ValueError, match="no rows"):
            fsa.fused_row_scatter(t, _t(np.array([1])),
                                  _t(np.zeros((0, 128), np.uint16)))
