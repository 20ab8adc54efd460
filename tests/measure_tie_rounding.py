"""How often the port's cosine of a bitwise-identical row pair equals the
JAX package's, bit for bit (ROADMAP Queue 3 item 1).

Run from the repository root on the CPU (~10 s):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/measure_tie_rounding.py

For random rows at widths 128 and 3,584 (each row paired with itself), it
prints the share of pairs where the port's ``similarity_by_patch``
arithmetic (``(a * b).sum / (‖a‖ · ‖b‖)``) gives JAX's fp32 value; where a
port-side variant (both norms from the dot's own reduction,
``sqrt((a * a).sum)``) gives it; and where JAX's value is exactly 1.0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

N = 4000


@jax.jit
def jax_cosine(a, b):
    # framefusion_tpu/core/similarity.py's arithmetic on (N, D) rows.
    return jnp.sum(a * b, axis=-1) / (jnp.linalg.norm(a, axis=-1) * jnp.linalg.norm(b, axis=-1))


def port_cosine(a, b):
    # framefusion_tpu_torch/core/similarity.py's arithmetic.
    return (a * b).sum(dim=-1) / (torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1))


def port_cosine_dot_norms(a, b):
    return (a * b).sum(dim=-1) / (torch.sqrt((a * a).sum(dim=-1)) * torch.sqrt((b * b).sum(dim=-1)))


def measure(width: int, seed: int = 0) -> dict:
    rows = np.random.default_rng(seed).standard_normal((N, width)).astype(np.float32)
    want = np.asarray(jax_cosine(jnp.asarray(rows), jnp.asarray(rows)))
    t = torch.from_numpy(rows)
    return {"width": width, "port_equals_jax": float(np.mean(port_cosine(t, t).numpy() == want)),
            "dot_norms_equal_jax": float(np.mean(port_cosine_dot_norms(t, t).numpy() == want)),
            "jax_exactly_one": float(np.mean(want == np.float32(1.0)))}


if __name__ == "__main__":
    torch.set_num_threads(1)
    for width in (128, 3584):
        print(measure(width))
