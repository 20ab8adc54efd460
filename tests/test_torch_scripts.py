"""The port's example scripts (``framefusion_tpu_torch.scripts``) on the CPU.

Each script's ``main([... "--device", "cpu"])`` runs in this process at a
small size and prints the table columns and JSON keys of the repository's
JAX script (read from that script's source, which is not run). The
model-taking functions of ``example_llava``, ``example_baselines``,
``example_batched`` and ``example_serving`` are held to the JAX entry points
their JAX scripts call, on the same weights (drawn once, carried to the port
with ``params_from_numpy``) and prompts, both sides on their plain fp32
path ("einsum"): compression events, tokens kept and generated tokens are
EQUAL. ``load_video_frames`` reads a frame directory into JAX's array, the
demo's self-test passes, and without a card a script run without
``--device cpu`` exits non-zero.
"""

import argparse
import ast
import importlib
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu.baselines import replace_forward as jax_replace_forward
from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.interface import FrameFusionModel as JaxModel
from framefusion_tpu.interface import apply_framefusion as jax_apply
from framefusion_tpu.models.adapters import llava_video as jax_llava
from framefusion_tpu.models.adapters.common import PrefillInputs as JaxInputs
from framefusion_tpu.runtime.engine import CompressionEngine as JaxEngine
from framefusion_tpu.runtime.serving import ServeRequest as JaxRequest
from framefusion_tpu.runtime.serving import ServingLoop as JaxLoop
from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters import llava_video
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from framefusion_tpu_torch.scripts import common, example_baselines, example_batched, example_serving

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("example_llava", "example_baselines", "example_longvideo", "example_batched", "example_serving",
           "example_qwen2vl", "example_internvl", "example_minicpmv", "example_nvila", "demo_compare")
FF = dict(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1)


def jax_dict_keys(script: str, has: str) -> set:
    """The string keys of the JAX script's dict literals that hold ``has``."""
    tree = ast.parse((ROOT / "scripts" / f"{script}.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            ks = {k.value for k in node.keys if isinstance(k, ast.Constant) and isinstance(k.value, str)}
            if has in ks:
                keys |= ks
    return keys


def jax_record_keys() -> set:
    """Every key JAX's ``example_serving`` writes into its JSON record."""
    tree = ast.parse((ROOT / "scripts" / "example_serving.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "record" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "update" \
                and getattr(node.func.value, "id", "") == "record":
            keys |= {k.value for k in node.args[0].keys}
        elif isinstance(node, ast.Subscript) and getattr(node.value, "id", "") == "record" \
                and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


def header(out: str, first: str) -> list:
    """The columns of the first table whose header starts with ``first``."""
    return next(line.split() for line in out.splitlines() if line.split()[:1] == [first])


def events(res):
    return [(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events] if res.telemetry else None


# -- each script's main on the CPU -----------------------------------------------------------------


@pytest.mark.parametrize("name,argv,first", [
    ("example_llava", ["--num-frames", "8", "--max-new-tokens", "4"], "method"),
    ("example_baselines", ["--num-frames", "4"], "method"),
    ("example_longvideo", ["--num-frames", "2"], "method"),
    ("example_qwen2vl", ["--num-frames", "4"], "method"),
    ("example_qwen2vl", ["--num-frames", "4", "--precomputed-features"], "method"),
    ("example_internvl", ["--num-frames", "4"], "method"),
    ("example_internvl", ["--num-frames", "4", "--precomputed-features"], "method"),
    ("example_minicpmv", ["--num-frames", "4"], "method"),
    ("example_nvila", ["--num-frames", "4"], "method"),
    ("example_nvila", ["--mode", "images"], "method"),
])
def test_example_main_prints_the_jax_table(capsys, name, argv, first):
    mod = importlib.import_module(f"framefusion_tpu_torch.scripts.{name}")
    mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    cols = header(out, first)
    assert set(cols) == jax_dict_keys(name, "method"), cols
    assert "host clock" in out
    if "speedup:" in (ROOT / "scripts" / f"{name}.py").read_text():
        assert "speedup:" in out


def test_example_batched_main_prints_the_jax_lines(capsys):
    example_batched.main(["--batch", "2", "--new-tokens", "4", "--batched-prefill", "--speculative",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("2 compressed prefills (ONE lockstep-batched program)", "batched[0] vs single agreement: 4/4",
                 "decode 4 tokens  B=1:", "decode 4 tokens  B=2:", "decode 4 tokens  B=2 speculative(oracle):"):
        assert line in out, line


def test_example_serving_main_writes_the_jax_record(tmp_path, capsys):
    path = tmp_path / "serving.json"
    example_serving.main(["--requests", "3", "--slots", "2", "--new-tokens", "8", "--fixed-budget",
                          "--sequential-baseline", "--speculative", "--tail-pool", "--json", str(path),
                          "--device", "cpu"])
    assert "batching speedup" in capsys.readouterr().out
    rec = json.loads(path.read_text(), parse_constant=lambda c: pytest.fail(f"non-JSON constant {c}"))
    assert set(rec) == jax_record_keys() | {"device"}
    assert rec["requests"] == 3 and rec["total_tokens"] == 24 and rec["parity_prefix"] == 8
    assert rec["speculative_agreement"] == "24/24" and rec["tail_pool"] is not None


def test_demo_selftest_on_the_cpu(capsys):
    """The two replicas stream at once (a thread each, the interpreter
    switching threads every microsecond): each stream grows and ends with
    its replica's solo tokens."""
    import sys

    from framefusion_tpu_torch.scripts import demo_compare

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = demo_compare.main(["--selftest", "--num-frames", "8", "--device", "cpu"])
    finally:
        sys.setswitchinterval(interval)
    assert "sanity ok" in capsys.readouterr().out
    assert all(len(v) >= 2 for v in out["partials"].values())


@pytest.mark.parametrize("name", SCRIPTS)
def test_without_a_card_a_script_needs_device_cpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"framefusion_tpu_torch.scripts.{name}")
    with pytest.raises(SystemExit) as exc:
        mod.main([])
    assert exc.value.code not in (0, None) and "--device cpu" in str(exc.value.code)


def test_load_video_frames_from_a_directory_equals_jax(tmp_path):
    import PIL.Image as Image

    from framefusion_tpu_torch.scripts.common import load_video_frames

    spec = importlib.util.spec_from_file_location("jax_scripts_common", ROOT / "scripts" / "common.py")
    jcommon = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcommon)
    rng = np.random.default_rng(0)
    for i in range(7):
        Image.fromarray(rng.integers(0, 255, size=(20, 24, 3), dtype=np.uint8)).save(tmp_path / f"f_{i:03d}.png")
    got = load_video_frames(str(tmp_path), num_frames=4, size=16)
    want = jcommon.load_video_frames(str(tmp_path), num_frames=4, size=16)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_video_frames(str(tmp_path / "empty"), 2, 8)


# -- the model-taking functions against the JAX entry points ---------------------------------------


def shared_weights(cfg, seed: int = 0):
    """(JAX params, port params) of one set of weights: the port's
    ``init_params`` drawn on the CPU, read as numpy, carried to the port with
    ``params_from_numpy`` and to JAX as arrays (the same layout; no JAX
    program is compiled to draw them)."""
    tree = jax.tree.map(lambda t: t.numpy(), tq.init_params(cfg, torch.Generator().manual_seed(seed)))
    return jax.tree.map(jnp.asarray, tree), tq.params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    """A 4-layer fp32 stack (``tiny_llm_config``) and its weights on both
    sides, with the JAX engine and the port's engine at the scripts' knobs."""
    jcfg, tcfg = jax_tiny(num_layers=4), tiny_llm_config(num_layers=4)
    jp, tp = shared_weights(tcfg)
    engines = (JaxEngine(jp, jcfg, JaxFF(**FF), attn_impl="einsum"),
               CompressionEngine(tp, tcfg, FrameFusionConfig(**FF), attn_impl="einsum"))
    return jcfg, tcfg, jp, tp, engines


def video_prompt(hidden: int, n_frames: int, patch_num: int = 20, n_text: int = 40, pos: int = 35):
    rng = np.random.default_rng(3)
    video = np.empty((n_frames * patch_num, hidden), np.float32)
    frame = rng.standard_normal((patch_num, hidden)) * 0.05
    for f in range(n_frames):
        frame = frame + 0.01 * rng.standard_normal(frame.shape)
        video[f * patch_num:(f + 1) * patch_num] = frame
    text = (rng.standard_normal((n_text, hidden)) * 0.05).astype(np.float32)
    return (jax_llava.build_prefill_inputs(text, video, pos, num_patches_per_side=9),
            llava_video.build_prefill_inputs(text, video, pos, num_patches_per_side=9))


def test_llava_ab_matches_jax_entry_points(tiny):
    """``common.ab_prefill`` (example_llava's A/B on a built model) against
    what JAX's example_llava calls: ``prefill`` of the dense and the
    FrameFusion model, ``generate_greedy`` from each."""
    jcfg, tcfg, jp, tp, _ = tiny
    j_in, t_in = video_prompt(jcfg.hidden_size, 8)
    jd = JaxModel(family="llava_video", cfg=jcfg, params=jp, attn_impl="einsum")
    jf = jax_apply(jd, 0.3, 0.6, 0.1)
    td = FrameFusionModel(family="llava_video", cfg=tcfg, params=tp)
    ab = common.ab_prefill(td, apply_framefusion(td, 0.3, 0.6, 0.1), t_in, max_new_tokens=6, reps=1)
    rd, rf = jd.prefill(j_in), jf.prefill(j_in)
    assert events(ab["ff"]) == events(rf) and events(ab["ff"])
    assert (ab["dense"].valid_len, ab["ff"].valid_len) == (rd.valid_len, rf.valid_len)
    assert ab["dense_tokens"] == jd.engine().generate_greedy(rd, 6)
    assert ab["ff_tokens"] == jf.engine().generate_greedy(rf, 6)
    assert [r["tokens_kept"] for r in common.ab_rows(ab)] == [rd.valid_len, rf.valid_len]


def test_baselines_compare_matches_jax_entry_points(tiny):
    """``compare`` against JAX's example_baselines methods (the same
    settings through ``replace_forward`` / ``apply_framefusion``): each
    method's tokens kept and events."""
    jcfg, tcfg, jp, tp, _ = tiny
    j_in, t_in = video_prompt(jcfg.hidden_size, 4, n_text=30, pos=25)
    rows, got = example_baselines.compare(FrameFusionModel(family="llava_video", cfg=tcfg, params=tp), t_in,
                                          reps=1, keep_results=True)
    jd = JaxModel(family="llava_video", cfg=jcfg, params=jp, attn_impl="einsum")
    n = jcfg.num_layers
    want = {"dense": jd, "framefusion": jax_apply(jd, 0.3, 0.6, 0.1),
            "fastv": jax_replace_forward(jd, "fastv", fastv_k=3, fastv_r=0.5),
            "streamingllm": jax_replace_forward(jd, "streamingllm", init_num=8, length_rate=0.3),
            "prefill_merge": jax_replace_forward(jd, "prefill_merge", sparsity=[0.1] * n),
            "merge_then_fastv": jax_replace_forward(jd, "merge_then_fastv", sparsity=[0.1] * n, fastv_k=3,
                                                    fastv_r=0.5),
            "fastv_then_merge": jax_replace_forward(jd, "fastv_then_merge", fastv_k=2, fastv_r=0.75,
                                                    merging_sparsity=0.3)}
    want["framefusion"].ff = want["framefusion"].ff.replace(schedule_num_layers=n)
    assert [r["method"] for r in rows] == list(want) == list(got)
    kept = set()
    for row, (name, m) in zip(rows, want.items()):
        res = m.prefill(j_in)
        assert row["tokens_kept"] == got[name].valid_len == res.valid_len, name
        assert events(got[name]) == events(res), name
        kept.add(res.valid_len)
    assert len(kept) > 3  # the methods keep different counts


def test_batched_matches_jax_entry_points(tiny):
    """``run_batched`` against what JAX's example_batched calls on the same
    prompts: ``prefill_planned_batch``, ``generate_batch``,
    ``generate_greedy`` and the oracle-seeded ``generate_spec_batch``."""
    _, tcfg, _, _, (eng_j, eng_t) = tiny
    prompts = example_batched.build_prompts(tcfg.hidden_size, 3, 8, 6)
    out = example_batched.run_batched(eng_t, prompts, 6, 6, batched_prefill=True, speculative=True)
    res_j = eng_j.prefill_planned_batch(prompts, patch_num=6)
    assert [r.valid_len for r in out["results"]] == [r.valid_len for r in res_j]
    assert [events(r) for r in out["results"]] == [events(r) for r in res_j]
    toks_b = eng_j.generate_batch(res_j, max_new_tokens=6)
    assert out["tokens_batch"] == toks_b
    assert out["tokens_single"] == eng_j.generate_greedy(res_j[0], 6)
    hints = [np.asarray(t, np.int32) for t in toks_b]
    assert out["tokens_spec"] == eng_j.generate_spec_batch(res_j, 6, prompt_ids=hints) == toks_b


def test_serving_matches_jax_serving_loop(tiny):
    """``serve`` against JAX's ``ServingLoop`` (what JAX's example_serving
    runs) over the same requests at 2 slots: every request's tokens, the
    chunk and compaction counts."""
    _, _, _, _, (eng_j, eng_t) = tiny
    reqs = example_serving.build_requests(eng_t, 4, 8, 6, 8, fixed_budget=False)
    args = argparse.Namespace(slots=2, chunk=4, new_tokens=8, arrival_rate=0.0, speculative=False,
                              sequential_baseline=False, slots_sweep=None, tail_pool=False, int8=False)
    record, results = example_serving.serve(eng_t, reqs, args, prefix_cap=256, frames=8)
    prefix_cap = max(256, len(reqs[0].inputs.patch_type) + eng_j.ff.bucket)
    loop = JaxLoop(eng_j, max_slots=2, max_new_cap=8, chunk_steps=4, draft_len=0, prefix_cap=prefix_cap)
    ids = [loop.submit(JaxRequest(JaxInputs(r.inputs.input_embeds, r.inputs.patch_type, r.inputs.position_ids,
                                            r.inputs.patch_num, r.inputs.image_token_start,
                                            r.inputs.image_token_length), max_new_tokens=r.max_new_tokens))
           for r in reqs]
    want = loop.run()
    assert [results[i].tokens for i in range(4)] == [want[i].tokens for i in ids]
    assert len({len(results[i].tokens) for i in range(4)}) > 1  # the budgets differ
    assert (record["chunks"], record["compactions"]) == (loop._chunk_idx, loop.compactions)
