"""The profiling path on the card (``cuda`` marker; skips without a CUDA
GPU, and imports no JAX): a profiler session around the hand kernels
records their device events and their declared counts, the roofline join
gives their rows counts within the datasheet bound, and op_bench's kernel
arms launch the hand kernels. ``chip_smoke.py`` phase 25 runs the same on
BERT-base."""
import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand kernels)")


@pytest.mark.cuda
def test_cuda_session_joins_flash_declarations(tmp_path):
    _need_card()
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.tools import roofline

    q = torch.randn(8, 12, 512, 64, device="cuda", dtype=torch.bfloat16)
    fa.flash_attention_fwd(q, q, q)
    with profiler.profiler(profile_path=str(tmp_path)):
        for _ in range(3):
            fa.flash_attention_fwd(q, q, q)
    tab = roofline.kernel_table(roofline.load_trace(str(tmp_path)),
                                (989.0, 3350.0), steps=3, cutoff_ms=0.0)
    (hand,) = [h for h in tab["hand_kernels"]
               if h["name"] == "flash_attention_fwd[bf16]"]
    assert hand["launches"] == 3 and hand["calls"] == 3
    assert 0.0 < hand["util_vs_bound"] <= 1.05


@pytest.mark.cuda
def test_cuda_op_bench_cells_launch_the_hand_kernels():
    _need_card()
    from paddle_tpu_torch.ops.kernels import flash_attention_sparse as fas
    from paddle_tpu_torch.ops.kernels import fused_bn
    from paddle_tpu_torch.tools import op_bench

    before = (fused_bn.conv_stats.launches,
              fas.flash_attention_sparse_fwd.launches)
    conv = op_bench.bench_fused_conv_bn(n_seg=1, tol=2e-5)
    attn = op_bench.bench_block_sparse_attn(n_seg=1, tol=2e-5)
    assert fused_bn.conv_stats.launches > before[0]
    assert fas.flash_attention_sparse_fwd.launches > before[1]
    assert all(conv["within_tol"].values()) and all(
        attn["within_tol"].values())
