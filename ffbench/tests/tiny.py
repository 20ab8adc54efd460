"""A tiny copy of the benchmark for CPU tests: the real harness, metrics and
traffic generator, over small configurations of both families."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TEXT = {"model_type": "qwen2", "vocab_size": 512, "hidden_size": 128, "intermediate_size": 256,
        "num_hidden_layers": 4, "num_attention_heads": 4, "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
        "rope_theta": 10000.0, "qkv_bias": True, "tie_word_embeddings": False,
        "init_std": 0.1}
CONFIGS = {
    "tiny-llava": {"kind": "llava_video", "text": TEXT,
                   "vision": {"image_size": 28, "patch_size": 7, "hidden_size": 64, "intermediate_size": 128,
                              "num_hidden_layers": 3, "num_attention_heads": 4, "layer_norm_eps": 1e-6,
                              "feature_layer": -2, "pool_stride": 2},
                   "framefusion": {"cost": 0.3, "similarity_lower_bound": 0.6, "ratio_lower_bound": 0.1}},
    "tiny-internvl": {"kind": "internvl", "text": dict(TEXT, qkv_bias=False),
                      "vision": {"image_size": 28, "patch_size": 7, "hidden_size": 64, "intermediate_size": 128,
                                 "num_hidden_layers": 2, "num_attention_heads": 4, "layer_norm_eps": 1e-6,
                                 "qkv_bias": True, "downsample_ratio": 0.5},
                      "framefusion": {"cost": 0.3, "similarity_lower_bound": 0.5, "ratio_lower_bound": 0.1}},
}
WORKLOADS = {"llava7b.qa": ("tiny-llava", "qa"), "llava7b.qa_bursts": ("tiny-llava", "qa_bursts"),
             "internvl8b.qa": ("tiny-internvl", "qa"), "llava7b.captions": ("tiny-llava", "captions")}
RATE = 2.0


def make_bench(root: Path, limits=None):
    """Write the tiny benchmark under ``root`` and return its ``Bench``."""
    from ffbench import run

    data = root / "ffbench"
    for d in ("configs", "traffic", "cells"):
        (data / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "ffbench" / "metrics", data / "metrics")
    for name, cfg in CONFIGS.items():
        cfg = dict(cfg, name=name, source="test", quantize="int8", dtype="float32")
        (data / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for mix in ("qa", "qa_bursts"):
        qa = json.loads((REPO / "ffbench" / "traffic" / f"{mix}.json").read_text())
        qa.update(frame_shape=[20, 24], frames={"values": [4, 6], "weights": [0.5, 0.5]}, answer_tokens=[3, 6],
                  serving={"slots": 2, "chunk_steps": 2, "max_new_tokens": 6, "prefix_margin": 128},
                  trace_seconds=1, check_requests=3)
        (data / "traffic" / f"{mix}.json").write_text(json.dumps(qa))
    cap = json.loads((REPO / "ffbench" / "traffic" / "captions.json").read_text())
    cap.update(frame_shape=[20, 24], frames={"values": [4], "weights": [1.0]}, answer_tokens=[10, 20], backlog=2,
               serving={"slots": 2, "chunk_steps": 2, "max_new_tokens": 20, "prefix_margin": 128},
               trace_seconds=1, check_requests=2)
    (data / "traffic" / "captions.json").write_text(json.dumps(cap))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "test", "file": f"ffbench/configs/{n}.json", "reduced": [],
                         "why": "test"} for n in CONFIGS]
    bench["workloads"] = [{"name": w, "config": c, "traffic": t, "chips": 1, "why": "test"}
                          for w, (c, t) in WORKLOADS.items()]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for w in WORKLOADS:
        cell = json.loads((REPO / "ffbench" / "cells" / f"{w}.json").read_text())
        cell["rate_rps"] = RATE
        if limits is not None:
            cell["limits"] = limits
        (data / "cells" / f"{w}.json").write_text(json.dumps(cell))
    return run.Bench(root / "BENCHMARK.json", data)
