"""The int8 accuracy gate on full-width BERT-base, on the CPU.

    python scripts/bert_int8_gate_cpu.py jax     # the JAX package
    python scripts/bert_int8_gate_cpu.py torch   # the port

Builds chip_smoke.py's BERT-base (vocab 30522, hidden 768, 12 layers, 12
heads, T = 128) with the chosen package from random_seed 2024, saves it,
and serves it with Config.enable_int8 on 8 seeded calibration feeds of
B = 8 (numpy seed 2024, chip_smoke.bert_feed): calibrate, rewrite, gate at
the default budget. Prints the decision, the accuracy delta and the counts
of quantized fc ops and tables. The weights differ between the packages
(each draws its own initializers from the seed), so the two deltas are
two samples of the same decision, not one number twice. Takes about a
minute (JAX) or three (the port) and ~2.5 GB of memory.
"""
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(which):
    if which == "jax":
        import jax
        jax.config.update("jax_default_matmul_precision", "highest")
        import paddle_tpu as fluid
        from paddle_tpu import inference
        from paddle_tpu.models import bert
    elif which == "torch":
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch import inference
        from paddle_tpu_torch.models import bert
    else:
        raise SystemExit(f"usage: {sys.argv[0]} jax|torch")
    import chip_smoke

    main_p, startup, feed_names, out = chip_smoke.build_bert(fluid, bert, 128)
    exe = fluid.Executor(fluid.CPUPlace())
    with tempfile.TemporaryDirectory() as d:
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            fluid.io.save_inference_model(d, feed_names, [out], exe,
                                          main_program=main_p)
        rng = np.random.RandomState(2024)
        feeds = [chip_smoke.bert_feed(8, 128, rng) for _ in range(8)]
        cfg = inference.Config(d)
        if which == "torch":
            cfg.disable_gpu()
        cfg.enable_int8(feeds)
        t0 = time.time()
        try:
            meta = inference.create_predictor(cfg).quant_meta
        except inference.QuantizationError as e:
            print(f"{which}: refused: {e} ({time.time() - t0:.0f} s)")
            return
    print(f"{which}: passes, accuracy_delta {meta['accuracy_delta']} "
          f"(budget {meta['accuracy_budget']}), {len(meta['fc'])} fc, "
          f"{len(meta['tables'])} tables ({time.time() - t0:.0f} s)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
