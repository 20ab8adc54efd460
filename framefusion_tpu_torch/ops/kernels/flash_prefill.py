"""Prefill attention: CUDA kernels A and B, their plain versions, dispatchers.

Counterpart of ``framefusion_tpu/ops/kernels/flash_prefill.py``. The TPU
file has three regimes of Pallas kernels because a head's K/V had to fit
VMEM; on the card one kernel covers every S (``csrc/flash_prefill.cu``,
whose header says what bounds each kernel and how the design meets it):

* ``flash_attn_fwd`` (kernel A) — causal GQA flash attention with an (S,)
  key-valid mask; also returns each row's softmax max ``m`` and sum ``l``
  ((Hq, S) fp32). Rows whose keys are all masked give 0.
* ``attn_importance_rows`` (kernel B) — the prune's importance vector from
  A's statistics, summed in a fixed order.

Each wrapper runs its plain PyTorch version when the tensors lie on the CPU
and launches the kernel when they lie on a CUDA device; anything else
raises. ``launches`` on each wrapper counts kernel launches.

``flash_causal_attention`` and ``flash_causal_attention_importance`` keep
the JAX package's entry points: (S, H, D) tensors in, attention (and the
importance of the last ``num`` live rows) out.
"""

from __future__ import annotations

import math

import torch

from ..attention import capture_rows

HEAD_DIM = 128
# Query rows per chunk of the plain attention: bounds its fp32 score block
# to chunk * Hq * S floats.
PLAIN_CHUNK = 512
SMEM_LIMIT = 48 * 1024


def _check_attn_inputs(q, k, v, key_valid):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"expected q (S,Hq,D), k/v (S,Hk,D); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    s, hq, d = q.shape
    if k.shape[0] != s or k.shape[2] != d or hq % k.shape[1]:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if key_valid is not None and (key_valid.shape != (s,) or key_valid.dtype != torch.bool):
        raise ValueError("key_valid must be an (S,) bool tensor")
    devices = {t.device for t in (q, k, v) + ((key_valid,) if key_valid is not None else ())}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def _check_cuda(name, *tensors, dtype=torch.bfloat16):
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: CUDA kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: CUDA kernel takes contiguous tensors")


def _device_route(name, t: torch.Tensor) -> bool:
    """True: launch the kernel; False: run the plain version (CPU tensor)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel for device {t.device}")


def flash_attn_fwd_plain(q, k, v, key_valid=None):
    """Plain version of kernel A: exact fp32 softmax, ``PLAIN_CHUNK`` query
    rows at a time against the keys up to the chunk's last row."""
    s, hq, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    scale = 1.0 / math.sqrt(d)
    kf = k.permute(1, 0, 2).to(torch.float32)  # (Hk, S, D)
    vf = v.permute(1, 0, 2).to(torch.float32)
    pos = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    m_all = torch.empty((hq, s), dtype=torch.float32, device=q.device)
    l_all = torch.empty_like(m_all)
    for r0 in range(0, s, PLAIN_CHUNK):
        r1 = min(s, r0 + PLAIN_CHUNK)
        n = r1 - r0
        qg = q[r0:r1].to(torch.float32).reshape(n, hk, g, d).permute(1, 2, 0, 3)
        sc = torch.einsum("hgnd,hkd->hgnk", qg, kf[:, :r1]) * scale
        mask = pos[None, :r1] <= pos[r0:r1, None]
        if key_valid is not None:
            mask = mask & key_valid[None, :r1]
        sc = torch.where(mask[None, None], sc, torch.full_like(sc, float("-inf")))
        m = sc.amax(dim=-1)
        m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(sc - m_safe[..., None])
        l = p.sum(dim=-1)
        o = torch.einsum("hgnk,hkd->hgnd", p, vf[:, :r1]) / torch.clamp(l, min=1e-30)[..., None]
        out[r0:r1] = o.permute(2, 0, 1, 3).reshape(n, hq, d).to(q.dtype)
        m_all[:, r0:r1] = m.reshape(hq, n)
        l_all[:, r0:r1] = l.reshape(hq, n)
    return out, m_all, l_all


def flash_attn_fwd(q, k, v, key_valid=None):
    """Kernel A: causal GQA attention with a key-valid mask.

    Args:
        q: (S, Hq, 128); k, v: (S, Hk, 128), bf16 on the card; key_valid:
            optional (S,) bool.
    Returns:
        (out (S, Hq, 128) in q's dtype, m (Hq, S) fp32, l (Hq, S) fp32).
    """
    _check_attn_inputs(q, k, v, key_valid)
    if not _device_route("flash_attn_fwd", q):
        return flash_attn_fwd_plain(q, k, v, key_valid)
    s, hq, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_attn_fwd: CUDA kernel takes head_dim {HEAD_DIM}, got {d}")
    _check_cuda("flash_attn_fwd", q, k, v)
    if key_valid is not None and not key_valid.is_contiguous():
        raise ValueError("flash_attn_fwd: key_valid must be contiguous")
    from ... import _build

    lib = _build.load_library()
    out = torch.empty_like(q)
    m = torch.empty((hq, s), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    status = lib.ff_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_valid.data_ptr() if key_valid is not None else None,
        out.data_ptr(), m.data_ptr(), l.data_ptr(),
        s, hq, k.shape[1], 1.0 / math.sqrt(d), _build.stream_ptr(q.device),
    )
    _build.check(status, "flash_attn_fwd")
    flash_attn_fwd.launches += 1
    return out, m, l


flash_attn_fwd.launches = 0


def attn_importance_rows_plain(q, k, rows, m, l, key_valid=None):
    """Plain version of kernel B."""
    s, hq, d = q.shape
    hk = k.shape[1]
    num = rows.shape[0]
    live = rows >= 0
    rp = torch.clamp(rows, min=0)
    qr = q[rp].to(torch.float32)  # (num, Hq, D)
    kfull = k.to(torch.float32).repeat_interleave(hq // hk, dim=1)  # (S, Hq, D)
    sc = torch.einsum("nhd,shd->nhs", qr, kfull) * (1.0 / math.sqrt(d))
    mask = (torch.arange(s, device=q.device)[None, :] <= rp[:, None]) & live[:, None]
    if key_valid is not None:
        mask = mask & key_valid[None, :]
    sc = torch.where(mask[:, None, :], sc, torch.full_like(sc, float("-inf")))
    mr = m[:, rp].T[..., None]  # (num, Hq, 1)
    lr = l[:, rp].T[..., None]
    absent = ~live[:, None, None]
    mr = torch.where(absent, torch.zeros_like(mr), mr)
    lr = torch.where(absent, torch.ones_like(lr), lr)
    p = torch.exp(sc - mr) / lr
    return p.sum(dim=(0, 1)) / (hq * num)


def attn_importance_rows(q, k, rows, m, l, key_valid=None):
    """Kernel B: importance of the capture rows from kernel A's statistics.

    Args:
        q: (S, Hq, 128), k: (S, Hk, 128) as given to kernel A; rows: (num,)
            int64 capture-row positions (-1 = absent); m, l: kernel A's
            (Hq, S) statistics; key_valid: optional (S,) bool.
    Returns:
        (S,) fp32: sum over capture rows and heads of the softmax
        probability of each key, divided by Hq * num.
    """
    if rows.dtype != torch.int64 or rows.ndim != 1:
        raise ValueError("rows must be a (num,) int64 tensor")
    if not _device_route("attn_importance_rows", q):
        return attn_importance_rows_plain(q, k, rows, m, l, key_valid)
    s, hq, d = q.shape
    num = rows.shape[0]
    if d != HEAD_DIM:
        raise ValueError(f"attn_importance_rows: CUDA kernel takes head_dim {HEAD_DIM}, got {d}")
    _check_cuda("attn_importance_rows", q, k)
    _check_cuda("attn_importance_rows", m, l, dtype=torch.float32)
    if m.shape != (hq, s) or l.shape != (hq, s):
        raise ValueError("m and l must be (Hq, S)")
    if any(t.device != q.device for t in (k, rows, m, l)):
        raise ValueError("attn_importance_rows: inputs on several devices")
    from ... import _build

    lib = _build.load_library()
    if lib.ff_attn_importance_rows_smem(hq, num) > SMEM_LIMIT:
        raise ValueError(f"attn_importance_rows: Hq={hq}, num={num} exceeds the kernel's shared memory")
    rows = rows.contiguous()
    imp = torch.empty((s,), dtype=torch.float32, device=q.device)
    status = lib.ff_attn_importance_rows(
        q.data_ptr(), k.data_ptr(), key_valid.data_ptr() if key_valid is not None else None,
        rows.data_ptr(), m.data_ptr(), l.data_ptr(), imp.data_ptr(),
        s, hq, k.shape[1], num, 1.0 / math.sqrt(d), _build.stream_ptr(q.device),
    )
    _build.check(status, "attn_importance_rows")
    attn_importance_rows.launches += 1
    return imp


attn_importance_rows.launches = 0


def flash_causal_attention(q, k, v, key_valid=None):
    """Causal GQA flash attention. q: (S, Hq, D); k, v: (S, Hk, D) -> (S, Hq, D)."""
    return flash_attn_fwd(q, k, v, key_valid)[0]


def flash_causal_attention_importance(q, k, v, valid_len, num: int, key_valid=None):
    """Attention plus the prune importance: the mean softmax mass the last
    ``num`` LIVE query rows pay to each key (live-rank selection with
    ``key_valid``, the trailing ``[valid_len - num, valid_len)`` window
    without). Returns (out (S, Hq, D), importance (S,) fp32)."""
    out, m, l = flash_attn_fwd(q, k, v, key_valid)
    rows = capture_rows(q.shape[0], num, valid_len, key_valid, device=q.device)
    return out, attn_importance_rows(q, k, rows, m, l, key_valid)

