"""PyTorch port vs the JAX package: the sequence-sharded compressed prefill.

JAX's ``seq_sharded_prefill`` runs over a 4-device ``seq`` mesh of the
virtual CPU devices (``tests/conftest.py``); the port's over 4 ``gloo``
CPU ranks (``parallel/launch.spawn``), one spawn for every case. The same
weights (JAX's ``init_params`` as numpy) and prompts, the scenarios of
``tests/test_parallel.py``'s ``TestSeqShardedCompression``: the K / V
gather, the ring (K / V rotated over ``batch_isend_irecv``, the capture
layer on the gather), and a 3D-mRoPE stack with 4 capture rows. Held:
events, final length and the sparsity history equal on every rank and to
JAX's; logits within 2e-3 (JAX's bound), the same argmax; and the
segmented executor of the port's own engine gives the same events.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.parallel.seq_shard import make_seq_mesh as jax_seq_mesh
from framefusion_tpu.parallel.seq_shard import seq_sharded_prefill as jax_seq_prefill
from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.parallel import launch, workers
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from test_core import make_sequence

# Tiny shapes: one intra-op thread each (pytest-xdist workers share the cores).
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="JAX's seq mesh needs 4 devices")

TOL = 2e-3
SEQ = 4


def _prompt(hidden, seed=0, coherent=0.8, pos3=False):
    rng = np.random.default_rng(seed)
    h, pt, img_start, n_img = make_sequence(rng, 5, 6, 12, 4, hidden=hidden, coherent=coherent)
    pos = np.arange(len(pt), dtype=np.int32)
    return ((h * 0.05).astype(np.float32), pt, np.tile(pos, (3, 1)) if pos3 else pos, 6, img_start, n_img)


CASES = {
    # name: (config kwargs, FrameFusion kwargs, prompt kwargs, ring)
    "gather": (dict(num_layers=6, num_heads=8, num_kv_heads=2), dict(schedule_num_layers=6), dict(), False),
    "ring": (dict(num_layers=6, num_heads=8, num_kv_heads=2), dict(schedule_num_layers=6), dict(coherent=0.55),
             True),
    "mrope_num4": (dict(num_layers=5, num_heads=8, num_kv_heads=2, mrope_section=(2, 3, 3)),
                   dict(schedule_num_layers=5, num_importance_queries=4, cost=0.35, similarity_lower_bound=0.7),
                   dict(seed=3, coherent=0.55, pos3=True), False),
}
FF = dict(cost=0.4, similarity_lower_bound=0.75, ratio_lower_bound=0.05, bucket=32)


@pytest.fixture(scope="module")
def runs():
    jobs, todo, ports = [], {}, {}
    for name, (cfg_kw, ff_kw, p_kw, ring) in CASES.items():
        jcfg, tcfg = jax_tiny(**cfg_kw), tiny_llm_config(**cfg_kw)
        jp = jq.init_params(jcfg, jax.random.PRNGKey(1 if name == "mrope_num4" else 0))
        params = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.device_get(jp))
        prompt = _prompt(jcfg.hidden_size, **p_kw)
        jff, tff = JaxFF(**{**FF, **ff_kw}), FrameFusionConfig(**{**FF, **ff_kw})
        jobs.append(dict(kind="seq", cfg=tcfg, ff=tff, params=params, seq=SEQ, ring=ring, prompt=prompt))

        def run(jp=jp, jcfg=jcfg, jff=jff, prompt=prompt, ring=ring):
            logits, tel, valid = jax_seq_prefill(jp, jcfg, jff, *prompt, jax_seq_mesh(jax.devices()[:SEQ]), ring=ring)
            return ([(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in tel.events], valid,
                    list(tel.sparsity_list), np.asarray(logits))

        todo[name] = run
        eng = CompressionEngine(tq.params_from_numpy(params, device="cpu"), tcfg, tff, attn_impl="einsum")
        ports[name] = workers.result_of(eng.prefill(*prompt, mode="segmented"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, workers.run_jobs, SEQ, jobs, backend="gloo", device="cpu", timeout_s=240)
        refs = {name: run() for name, run in todo.items()}
        outs = ranks.result()
    return refs, ports, {name: [o[j] for o in outs] for j, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_seq_sharded_prefill_matches_jax(runs, name):
    refs, _, outs = runs
    events, valid, sparsity, logits = refs[name]
    if name != "gather":
        assert any(e[1] == "prune" for e in events), "want a capture layer"
    for got in outs[name]:
        assert got["events"] == events and got["valid_len"] == valid
        assert got["sparsity"] == pytest.approx(sparsity, abs=1e-7)
        np.testing.assert_allclose(got["logits"], logits, rtol=TOL, atol=TOL)
        assert int(np.argmax(got["logits"])) == int(np.argmax(logits))


@pytest.mark.parametrize("name", list(CASES))
def test_seq_sharded_prefill_decides_as_the_segmented_executor(runs, name):
    _, ports, outs = runs
    got, want = outs[name][0], ports[name]
    assert got["events"] == want["events"] and got["valid_len"] == want["valid_len"]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=TOL, atol=TOL)


def test_seq_sharded_prefill_refuses_a_moe_stack():
    from framefusion_tpu_torch.config import tiny_moe_llm_config
    from framefusion_tpu_torch.parallel.seq_shard import seq_sharded_prefill

    with pytest.raises(ValueError, match="dense stacks"):
        seq_sharded_prefill({}, tiny_moe_llm_config(), FrameFusionConfig(), None, None, None, 6, 0, 0, mesh=None)
