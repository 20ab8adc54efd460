"""The frozen reference against the port's plain path, at tiny sizes on the CPU.

In fp32 on the CPU the port runs its kernels' plain versions, so the two
must agree to rounding: pixels, video tokens, and every served token the
reference's best."""

import numpy as np
import pytest
import torch

from ffbench import run
from ffbench.reference import common

SEED = 2**31 + 7


@pytest.mark.parametrize("workload", ["llava7b.qa", "internvl8b.qa", "llava7b.captions"])
def test_reference_agrees_with_the_port(tiny_bench, workload):
    result, checks = run.run_cell(tiny_bench, workload, SEED, 2.0, False, device="cpu")
    assert result["correct"], checks
    assert checks["pixel_err"]["value"] < 1e-5
    assert checks["feature_err"]["value"] < 1e-5
    assert checks["logit_gap"]["value"] < 1e-4


@pytest.mark.parametrize("family,size", [("llava_video", 28), ("internvl", 56)])
def test_preprocess_matches_the_port(family, size):
    from framefusion_tpu_torch import preprocess as pp

    from ffbench.reference import internvl, llava_video

    ref = llava_video if family == "llava_video" else internvl
    frames = np.random.default_rng(0).integers(0, 256, (3, 37, 45, 3)).astype(np.uint8)
    want = common.preprocess(frames, size, ref.MEAN, ref.STD)
    got = pp.preprocess_frames(frames, family, target=(size, size), impl="numpy")
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_int8_rounding_is_the_port_quantization():
    from framefusion_tpu_torch.ops.quant import dequantize_weight, quantize_weight

    w = torch.randn(3, 64, 48, dtype=torch.bfloat16)
    torch.testing.assert_close(common.int_weight(w, 8), dequantize_weight(quantize_weight(w)), rtol=0, atol=0)
    err8 = (common.int_weight(w, 8) - w.float()).abs().mean()
    err4 = (common.int_weight(w, 4) - w.float()).abs().mean()
    err_fp8 = (common.fp8_weight(w) - w.float()).abs().mean()
    assert err4 > 8 * err8 and err_fp8 > err8


def test_capped_merge_averages_runs_into_their_head():
    # 3 frames x 2 patches: patch 0 alike in every frame, patch 1 alike in
    # frames 0-1 and new in frame 2. The budget (cost 0.5) takes 3 of the 6
    # frame tokens, the three most similar: both later patch-0 tokens run
    # into frame 0's, and frame 1's patch 1 into frame 0's.
    h = torch.zeros(8, 4)
    h[[1, 3, 5], 0] = torch.tensor([1.0, 1.01, 1.02])
    h[[2, 4], 1] = torch.tensor([1.0, 1.03])
    h[6, 2] = 1.0
    h[0, 3] = h[7, 3] = 1.0
    pt = torch.tensor([-1, 0, 1, 0, 1, 0, 1, -1])
    st = common.FFState(cost=0.5, s_th=0.5, r_min=0.1, frame_tok=6, orig_len=8, image_start=1, image_len=6)
    merged, keep = common.merge_event(st, h, pt, 8, -1)
    assert st.events == [(-1, "merge_capped", 3)] and st.done
    assert keep.tolist() == [True, True, True, False, False, False, True, True]
    torch.testing.assert_close(merged[1], h[[1, 3, 5]].mean(0))
    torch.testing.assert_close(merged[2], h[[2, 4]].mean(0))
    torch.testing.assert_close(merged[6], h[6])


def test_the_schedule_matches_the_port():
    from framefusion_tpu_torch.core.schedule import pruning_ratio_flagged

    for sparsity, cost in (([], 0.3), ([0.4], 0.3), ([0.5, 0.2], 0.5), ([0.9, 0.9], 0.05)):
        assert common.pruning_ratio(sparsity, cost) == pruning_ratio_flagged(sparsity, cost, 28)
