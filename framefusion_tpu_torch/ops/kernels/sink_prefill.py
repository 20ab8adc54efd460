"""StreamingLLM prefill attention: CUDA kernel F, its plain version, the entry point.

Counterpart of ``framefusion_tpu/ops/kernels/sink_prefill.py``. Query i
attends the ``init_num`` sink keys and its trailing ``window`` keys (the
query itself included):

    {j : j <= i and (j < init_num or j > i - window)}

* ``sink_attn_fwd`` (kernel F, ``csrc/sink_prefill.cu``, whose header says
  what bounds it and how the design meets that) — visits only the sink and
  window key tiles of each query tile: O(S * (init_num + window)) work, not
  O(S^2).
* ``sink_attn_fwd_plain`` — exact fp32 softmax, ``PLAIN_CHUNK`` query rows
  at a time against only the keys they can see.

The wrapper runs the plain version when the tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; anything else raises.
``sink_attn_fwd.launches`` counts kernel launches.

``sink_flash_attention`` keeps the JAX package's entry point, clamps
included (``window >= 1``, ``init_num >= 0``).
"""

from __future__ import annotations

import math

import torch

from .flash_prefill import HEAD_DIM, PLAIN_CHUNK, _check_attn_inputs, _check_cuda, _device_route


def _check_sink_args(init_num: int, window: int) -> None:
    if window < 1 or init_num < 0:
        raise ValueError(f"sink attention takes window >= 1 and init_num >= 0, got {window}, {init_num}")


def sink_attn_fwd_plain(q, k, v, init_num: int, window: int):
    """Plain version of kernel F: for each chunk of ``PLAIN_CHUNK`` query
    rows, fp32 scores against the sink keys below the chunk's window and
    every key from the window's start to the chunk's last row, masked per
    row, then an exact softmax."""
    _check_sink_args(init_num, window)
    s, hq, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    scale = 1.0 / math.sqrt(d)
    kf = k.permute(1, 0, 2).to(torch.float32)  # (Hk, S, D)
    vf = v.permute(1, 0, 2).to(torch.float32)
    out = torch.empty_like(q)
    for r0 in range(0, s, PLAIN_CHUNK):
        r1 = min(s, r0 + PLAIN_CHUNK)
        n = r1 - r0
        lo = max(r0 - window + 1, 0)
        keys = torch.cat([torch.arange(min(init_num, lo), device=q.device),
                          torch.arange(lo, r1, device=q.device)])
        qg = q[r0:r1].to(torch.float32).reshape(n, hk, g, d).permute(1, 2, 0, 3)
        sc = torch.einsum("hgnd,hkd->hgnk", qg, kf[:, keys]) * scale
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        mask = (keys[None, :] <= rows) & ((keys[None, :] < init_num) | (keys[None, :] > rows - window))
        sc = torch.where(mask[None, None], sc, torch.full_like(sc, float("-inf")))
        p = torch.softmax(sc, dim=-1)  # every row sees at least itself
        o = torch.einsum("hgnk,hkd->hgnd", p, vf[:, keys])
        out[r0:r1] = o.permute(2, 0, 1, 3).reshape(n, hq, d).to(q.dtype)
    return out


def sink_attn_fwd(q, k, v, init_num: int, window: int):
    """Kernel F: sink + window GQA attention.

    Args:
        q: (S, Hq, 128); k, v: (S, Hk, 128), bf16 and contiguous on the
            card; init_num >= 0 sink keys; window >= 1 trailing keys.
    Returns:
        (S, Hq, 128) in q's dtype.
    """
    _check_attn_inputs(q, k, v, None)
    _check_sink_args(init_num, window)
    if not _device_route("sink_attn_fwd", q):
        return sink_attn_fwd_plain(q, k, v, init_num, window)
    s, hq, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"sink_attn_fwd: CUDA kernel takes head_dim {HEAD_DIM}, got {d}")
    _check_cuda("sink_attn_fwd", q, k, v)
    from ... import _build

    lib = _build.load_library()
    out = torch.empty_like(q)
    status = lib.ff_sink_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        s, hq, k.shape[1], int(init_num), int(window), 1.0 / math.sqrt(d), _build.stream_ptr(q.device),
    )
    _build.check(status, "sink_attn_fwd")
    sink_attn_fwd.launches += 1
    return out


sink_attn_fwd.launches = 0


def sink_flash_attention(q, k, v, init_num: int, window: int):
    """StreamingLLM prefill attention. q: (S, Hq, D); k, v: (S, Hk, D) ->
    (S, Hq, D). ``window`` is clamped to >= 1 and ``init_num`` to >= 0, as
    in the JAX kernel."""
    return sink_attn_fwd(q, k, v, max(int(init_num), 0), max(int(window), 1))
