"""The port's ``kernel_bench`` modes on the CPU: their counts and their refusal.

The ``--what`` modes (attn, quant, decode, engine, ledger, all) run on the
card only; here each exits non-zero at once, and the plain functions that
give each row its bound (operations and bytes from shapes) are held to
counts done by hand at Qwen2-7B's shapes.
"""

import pytest
import torch

from framefusion_tpu_torch import kernel_bench as kb
from framefusion_tpu_torch.config import qwen2_7b_config

torch.set_num_threads(1)

CFG = qwen2_7b_config()
P_ATTN = 3584 * (3584 + 512 + 512) + 3584 * 3584  # q, k, v, o
P_MLP = 3 * 3584 * 18944  # gate, up, down


@pytest.mark.parametrize("mode", ["attn", "quant", "decode", "engine", "ledger", "all", "decodestep"])
def test_what_takes_every_mode_and_needs_the_card(mode, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the mode would run")
    with pytest.raises(SystemExit) as exc:
        kb.main(["--what", mode])
    assert exc.value.code == 1 and "no CUDA device" in capsys.readouterr().err


def test_what_refuses_unknown_modes():
    with pytest.raises(SystemExit) as exc:
        kb.main(["--what", "tail-scan"])  # JAX's XLA-only tail variants have no mode here
    assert exc.value.code == 2


@pytest.mark.parametrize("fn", [kb.bench_attention, kb.bench_quant, kb.bench_decode, kb.bench_engine,
                                kb.bench_ledger, kb.engine_model])
def test_bench_functions_refuse_without_the_card(fn):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit):
        fn()


def test_bound_picks_the_larger_time():
    ms, by = kb.bound_ms(3.35e9, 0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = kb.bound_ms(0, 989e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = kb.bound_ms(1.0, 1979e9, kb.H100_INT8_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_attention_counts():
    s = 3328
    assert kb.attn_flops(s, 28, 128) == 2 * 2 * 28 * 128 * (s * (s + 1) // 2)
    # q (S, 28, 128) and k, v (S, 4, 128) in bf16, the bf16 output and fp32 m, l out
    assert kb.attn_bytes(s, 28, 4, 128) == 2 * (s * 28 * 128 + 2 * s * 4 * 128) + 2 * s * 28 * 128 + 2 * s * 28 * 4
    assert kb.ATTN_LENGTHS == (3328, 3456, 6656, 11776, 23552)


def test_gemm_and_matvec_counts():
    m, k, n = kb.QUANT_SHAPE
    assert (m, k, n) == (3328, 3584, 18944)
    assert kb.gemm_flops(m, k, n) == 2 * 3328 * 3584 * 18944
    assert kb.gemm_bytes(m, k, n, 1, 4) == 3328 * 3584 + 3584 * 18944 + 4 * 3328 * 18944
    # int8 qkv: three weight blocks, their fp32 scales, the bf16 row in, three fp32 outputs
    assert kb.matvec_bytes(3584, (3584, 512, 512), 1) == 3584 * 4608 + 4 * 4608 + 2 * 3584 + 4 * 4608
    # bf16 gate-up (kernel D): two weight blocks, one fp32 product out
    assert kb.matvec_bytes(3584, (18944, 18944), 2) == 2 * 2 * 3584 * 18944 + 2 * 3584 + 4 * 18944
    assert kb.matvec_bytes(18944, (3584,), 1, rows=4) == 18944 * 3584 + 4 * 3584 + 4 * 2 * 18944 + 4 * 4 * 3584


def test_prefill_ops_follow_the_events():
    assert kb.layer_params(CFG) == (P_ATTN, P_MLP)
    s, layers = 11697, 28
    dense = kb.prefill_ops(CFG, s)
    assert dense == layers * (2 * s * (P_ATTN + P_MLP) + kb.attn_flops(s, 28, 128)) + 2 * 3584 * 152064
    # a layer -1 merge of 5,000, a layer-0 merge of 1,000 (after layer 0's attention), a layer-2 prune of 3,000
    events = [(-1, 5000), (0, 1000), (2, 3000)]
    rows_attn = [6697, 5697, 5697] + [2697] * 25
    rows_mlp = [5697, 5697, 2697] + [2697] * 25
    want = sum(2 * a * P_ATTN + kb.attn_flops(a, 28, 128) + 2 * b * P_MLP for a, b in zip(rows_attn, rows_mlp))
    assert kb.prefill_ops(CFG, s, events) == want + 2 * 3584 * 152064
    # the tail alone: layers 3-27 over the survivors, no logits
    tail = 25 * (2 * 2697 * (P_ATTN + P_MLP) + kb.attn_flops(2697, 28, 128))
    assert kb.prefill_ops(CFG, 2697, start_layer=3, logits_rows=0) == tail
    assert kb.prefill_ops(CFG, s, events, start_layer=3, logits_rows=0) == tail


def test_row_failures_reads_each_checked_row():
    rows = [dict(name="timed only", ms=1.0), dict(name="in", ms=1.0, err=1e-3, tol=2e-2),
            dict(name="at the bound", ms=1.0, err=2e-2, tol=2e-2), dict(name="off", ms=1.0, err=3e-2, tol=2e-2),
            dict(name="nan", ms=1.0, err=float("nan"), tol=2e-2), dict(name="events differ", ms=1.0,
                                                                      err=float("inf"), tol=2e-2)]
    assert kb.row_failures(rows) == ["off", "nan", "events differ"]


def test_logits_err_needs_the_reference_events():
    from types import SimpleNamespace

    ev = [SimpleNamespace(layer=-1, tokens_removed=5), SimpleNamespace(layer=1, tokens_removed=3)]
    ref = SimpleNamespace(telemetry=SimpleNamespace(events=ev), valid_len=12,
                          logits=torch.tensor([1.0, -4.0, 2.0]))
    out = torch.tensor([1.0, -4.0, 2.4])
    assert kb.logits_err(out, [(-1, 5), (1, 3)], 12, ref) == pytest.approx(0.1)
    assert kb.logits_err(out, [(-1, 5), (1, 2)], 12, ref) == float("inf")
    assert kb.logits_err(out, [(-1, 5), (1, 3)], 11, ref) == float("inf")
