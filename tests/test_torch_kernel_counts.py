"""What the hand kernels declare, on the CPU.

Each kernel module computes a launch's flops and bytes from its shapes
(``fwd_counts``, ``stats_counts``, ``adagrad_counts``, ...); the chip
check's bounds, the perf ledger's counted source and the roofline join
read those functions. Here they are held equal to the formulas the chip
check wrote inline before they moved (copied below as they were), a
wrapper declares exactly at a kernel launch (its counts, its row and the
base names of the kernels the launch runs; nothing on the plain route,
nothing with no collector), and `kernel_label` reads mangled names as the
chip check did and demangled ones (a torch.profiler trace's) alike."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.observability import kernel_counts
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import flash_attention_sparse as fas
from paddle_tpu_torch.ops.kernels import fused_bn as fb
from paddle_tpu_torch.ops.kernels import sparse_adagrad as fsa

torch.set_num_threads(1)


# -- the formulas as the chip check wrote them inline ----------------------------

def old_flash(b, nh, t, d, isz, bias_bytes):
    hidden = nh * d
    fwd = (4.0 * b * nh * t * t * d,
           4 * b * t * hidden * isz + b * nh * t * 4 + bias_bytes)
    bwd = (10.0 * b * nh * t * t * d,
           8 * b * t * hidden * isz + 2 * b * nh * t * 4 + bias_bytes)
    return fwd, bwd


def old_sparse(b, nh, tq, tk, d, isz, pairs, small):
    fwd_bytes = (2 * tq + 2 * tk) * b * nh * d * isz + b * nh * tq * 4 + small
    bwd_bytes = ((4 * tq + 4 * tk) * b * nh * d * isz + 2 * b * nh * tq * 4
                 + small)
    return (4.0 * d * pairs, fwd_bytes), (10.0 * d * pairs, bwd_bytes)


@pytest.mark.parametrize("b,nh,t,d,dtype", [
    (8, 12, 512, 64, torch.bfloat16), (8, 12, 128, 64, torch.float32),
    (2, 16, 256, 128, torch.bfloat16), (1, 2, 64, 320, torch.float32)])
def test_flash_counts_equal_the_inline_formulas(b, nh, t, d, dtype):
    q = torch.zeros(b, nh, t, d, dtype=dtype)
    bias = torch.zeros(b, 1, 1, t, dtype=dtype)
    fwd, bwd = old_flash(b, nh, t, d, q.element_size(),
                         bias.numel() * bias.element_size())
    assert fa.fwd_counts(q, q, bias) == fwd
    assert fa.bwd_counts(q, q, bias) == bwd
    no_bias = old_flash(b, nh, t, d, q.element_size(), 0)
    assert (fa.fwd_counts(q, q), fa.bwd_counts(q, q)) == no_bias


def test_sparse_counts_equal_the_inline_formulas():
    rng = np.random.RandomState(0)
    b, nh, t, d = 2, 4, 128, 64
    seg = torch.tensor(np.sort(rng.randint(1, 4, (b, t)), 1), dtype=torch.int32)
    se = fas.pack_se(seg, seg)
    vis = fas.compute_block_vis(se, t, t, fas.TILE, fas.TILE, False)
    q = torch.zeros(b, nh, t, d, dtype=torch.bfloat16)
    smask = fas._mask(se, None, t, t, False)
    pairs = int(smask.sum()) * nh
    small = se.numel() * 4 + vis.numel() * 4
    fwd, bwd = old_sparse(b, nh, t, t, d, 2, pairs, small)
    assert fas.fwd_counts(q, q, se, vis, pairs) == fwd
    assert fas.bwd_counts(q, q, se, vis, pairs) == bwd
    lazy = fas.visible_pairs(se, t, t, False, nh)
    assert isinstance(lazy, torch.Tensor) and int(lazy) == pairs
    assert float(fas.fwd_counts(q, q, se, vis, lazy)[0]) == fwd[0]


@pytest.mark.parametrize("m,c,isz", [(401408, 64, 2), (25088, 2048, 4)])
def test_fused_bn_counts_equal_the_inline_formulas(m, c, isz):
    ci, co = c, 4 * c
    assert fb.conv_stats_counts(m, ci, co, isz) == (
        2.0 * m * ci * co, (m * ci + ci * co + m * co) * isz + 2 * co * 4)
    assert fb.bwd_counts(m, co, isz) == (10.0 * m * co,
                                         3 * m * co * isz + 5 * co * 4)
    assert fb.bwd_reduce_counts(m, co, isz) == (
        4.0 * m * co, 2 * m * co * isz + 4 * co * 4)
    assert fb.bwd_dx_counts(m, co, isz) == (6.0 * m * co,
                                            3 * m * co * isz + 5 * co * 4)
    assert fb.stats_counts(m, c, isz) == (3.0 * m * c, m * c * isz + 2 * c * 4)
    for act, has_res in (("", False), ("relu", False), ("relu", True)):
        assert fb.apply_counts(m, c, isz, act, has_res) == (
            (4.0 + has_res + (act == "relu")) * m * c,
            (2 + has_res) * m * c * isz + 3 * c * 4)


def test_sparse_adagrad_counts_equal_the_inline_formulas():
    rows, vis, nu = 256 * 26, 10, 6000
    assert fsa.adagrad_counts(nu, rows, vis) == (
        6.0 * nu * vis,
        nu * (8 + 4 * vis + 8 * vis + 2 * fsa.PACK_LANES) + (rows - nu) * 8)
    n, n_slots, n_src = 4096, 3585, 3585
    row_bytes = 2 * fsa.PACK_LANES
    assert fsa.gather_counts(n_slots, n)[1] == (n_slots + n) * row_bytes \
        + n * 8
    assert fsa.scatter_counts(n_src, n_slots, n)[1] == \
        (n_src + n_slots) * row_bytes + n * 16
    slots = torch.tensor([5, 3, 5, 9, 9, 9])
    assert int(fsa.distinct(slots)) == len(np.unique(slots.numpy())) == 3
    assert int(fsa.distinct(slots[:0])) == 0


# -- declarations at launches -------------------------------------------------

def test_plain_route_and_no_collector_declare_nothing():
    q = torch.randn(1, 2, 64, 64)
    with kernel_counts.collect() as d:
        fa.flash_attention_fwd(q, q, q)      # CPU: the plain version
    assert not d and d.totals() == {}
    assert not kernel_counts.active()


def test_wrappers_declare_at_a_launch(monkeypatch):
    """With the route forced to the kernel and the launch replaced by the
    plain version, each wrapper declares its row, kernels and counts."""
    q = torch.randn(2, 2, 64, 64, dtype=torch.bfloat16)
    bias = torch.zeros(2, 1, 1, 64, dtype=torch.bfloat16)
    monkeypatch.setattr(fa, "_use_kernel", lambda fn, q: True)
    monkeypatch.setattr(fa, "_launch_fwd_bf16",
                        lambda q, k, v, bias, *a: fa.flash_attention_fwd_plain(
                            q, k, v, bias))
    monkeypatch.setattr(fa, "_launch_bwd_bf16", lambda *a: None)
    with kernel_counts.collect() as d:
        out, lse = fa.flash_attention_fwd(q, q, q, bias)
        fa.flash_attention_bwd(q, q, q, out, lse, out, bias)
    tot = d.totals()
    assert tot["flash_attention_fwd[bf16]"] == {
        "kernels": ["flash_fwd_bf16_kernel"], "calls": 1,
        "flops": fa.fwd_counts(q, q, bias)[0],
        "bytes": float(fa.fwd_counts(q, q, bias)[1])}
    assert tot["flash_attention_bwd[bf16]"]["kernels"] == [
        "flash_bwd_delta_kernel", "flash_bwd_dq_bf16_kernel",
        "flash_bwd_dkv_bf16_kernel"]
    assert fa.launch_kernels("bwd", torch.float32, 512) == (
        "flash_attention_bwd[f32,wide]",
        ("flash_bwd_delta_kernel", "wide_role_f32_kernel",
         "wide_bwd_f32_kernel"))
    assert fa.launch_kernels("fwd", torch.bfloat16, 64, sparse=True) == (
        "flash_attention_sparse_fwd[bf16]", ("sparse_fwd_bf16_kernel",))


def test_fused_bn_and_rows_declare_at_a_launch(monkeypatch):
    x = torch.randn(2, 64, 32, 32)
    w = torch.randn(128, 64, 1, 1)
    monkeypatch.setattr(fb, "_route", lambda t, name: True)
    monkeypatch.setattr(fb, "_launch_conv_stats", fb.conv_stats_plain)
    monkeypatch.setattr(fb, "_launch_stats", fb.stats_plain)
    table = torch.zeros(100, fsa.PACK_LANES, dtype=torch.uint16)
    slots = torch.tensor([1, 2, 2, 7])
    monkeypatch.setattr(fsa, "_route", lambda t, name: True)
    monkeypatch.setattr(fsa, "_launch_gather",
                        fsa.fused_row_gather_plain)
    with kernel_counts.collect() as d:
        fb.conv_stats(x, w)
        fb.bn_stats(x)
        fsa.fused_row_gather(table, slots)
    tot = d.totals()
    m = 2 * 32 * 32
    assert tot["fused_conv_stats[f32]"]["kernels"] == [
        "conv_stats_f32_kernel", "finish_kernel"]
    assert (tot["fused_conv_stats[f32]"]["flops"],
            tot["fused_conv_stats[f32]"]["bytes"]) == \
        fb.conv_stats_counts(m, 64, 128, 4)
    assert (tot["fused_bn_stats[f32]"]["flops"],
            tot["fused_bn_stats[f32]"]["bytes"]) == \
        fb.stats_counts(m, 64, 4)
    # three distinct slots of four: data-dependent, summed once at the end
    assert tot["sparse_row_gather"]["bytes"] == \
        fsa.gather_counts(3, 4)[1]


# -- names ------------------------------------------------------------------------

@pytest.mark.parametrize("name,label", [
    ("_ZN2fa21flash_fwd_bf16_kernelILi64EEEvNS_9FwdParamsE",
     "flash_fwd_bf16_kernel<64>"),
    (".text._ZN3fas21sparse_fwd_f32_kernelILi128ELi64EEEvNS_1PE",
     "sparse_fwd_f32_kernel<128, 64>"),
    ("_ZN3fbn12apply_kernelI13__nv_bfloat16Lb1ELb0EEEvPKT_",
     "apply_kernel<bf16, res=1, relu=0>"),
    ("_Z21conv_stats_f32_kernelILb1EEvPKf", "conv_stats_f32_kernel"
     "<resident W=1>"),
    ("_ZN4f32w20wide_role_f32_kernelILi2ELb0EEEvNS_1PE",
     "wide_role_f32_kernel<dk, sparse=0>"),
    ("void fa::flash_fwd_bf16_kernel<64>(fa::FwdParams)",
     "flash_fwd_bf16_kernel<64>"),
    ("void fbn::apply_kernel<__nv_bfloat16, true, false>(P)",
     "apply_kernel<bf16, res=1, relu=0>"),
    ("void conv_stats_bf16_kernel<128, 2, 65536>(P)",
     "conv_stats_bf16_kernel<BN=128, CTAs/SM=2, resident W=65536 B>"),
    ("void bfw::wide_fwd_bf16_kernel<(bool)1>(P)",
     "wide_fwd_bf16_kernel<sparse=1>"),
    ("void sa::adagrad_kernel(unsigned short*, long const*)",
     "adagrad_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, F>(int, F)", None),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT", None),
])
def test_kernel_label_reads_mangled_and_demangled_names(name, label):
    assert kernel_counts.kernel_label(name) == label
    if label is not None:
        assert kernel_counts.base_name(name) == label.split("<")[0]
