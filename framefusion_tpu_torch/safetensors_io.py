"""A reader of the safetensors format, with numpy and torch only.

A safetensors file is an 8-byte little-endian header length ``n``, ``n``
bytes of JSON (``{name: {"dtype", "shape", "data_offsets": [begin, end]}}``
and an optional ``"__metadata__"`` of strings; the offsets count from the
first byte after the header), then the tensors' raw little-endian bytes.

``read_file`` maps the file with ``numpy.memmap`` and returns each tensor as
a view of that map, so nothing is read until a tensor is used, and a tensor
that is only copied or converted once is never held twice. The map is
copy-on-write: a write to a tensor changes this process's pages, never the
file. BF16 reads as ``uint16`` and is viewed as ``torch.bfloat16`` (numpy has
no bf16). A dtype outside ``DTYPES``, a header that does not parse, or a
tensor whose bytes overrun the file raises ``ValueError`` with the file and
the tensor's name.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the stored bytes, torch dtype to view
# them as where numpy has none).
DTYPES = {
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "F16": (np.dtype("<f2"), None),
    "F32": (np.dtype("<f4"), None),
    "F64": (np.dtype("<f8"), None),
    "I8": (np.dtype("i1"), None),
    "U8": (np.dtype("u1"), None),
    "I16": (np.dtype("<i2"), None),
    "I32": (np.dtype("<i4"), None),
    "I64": (np.dtype("<i8"), None),
    "BOOL": (np.dtype("?"), None),
}


def read_header(path: str) -> tuple[dict, int, int]:
    """``(header without "__metadata__", first data byte, data bytes)`` of
    the file at ``path``."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        n = int.from_bytes(head, "little")
        if 8 + n > size:
            raise ValueError(f"{path}: the header claims {n} bytes, the file holds {size - 8} after its length")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise ValueError(f"{path}: the header is not JSON ({exc})") from exc
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    header.pop("__metadata__", None)
    return header, 8 + n, size - 8 - n


def read_file(path: str) -> dict:
    """Every tensor of one safetensors file: name -> CPU tensor, a view of
    the file's copy-on-write map (module docstring)."""
    header, start, n_data = read_header(path)
    data = (np.memmap(path, dtype=np.uint8, mode="c", offset=start, shape=(n_data,)) if n_data
            else np.empty(0, np.uint8))
    out = {}
    for name, info in header.items():
        kind = info.get("dtype") if isinstance(info, dict) else None
        if kind not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {kind!r}; this reader takes {sorted(DTYPES)}")
        np_dtype, view_as = DTYPES[kind]
        try:
            shape = tuple(int(s) for s in info["shape"])
            begin, end = (int(x) for x in info["data_offsets"])
        except (KeyError, TypeError, ValueError) as exc:
            raise ValueError(f"{path}: tensor {name!r} has no readable shape and data_offsets ({exc!r})") from exc
        want = math.prod(shape) * np_dtype.itemsize
        if not 0 <= begin <= end <= n_data or end - begin != want:
            raise ValueError(f"{path}: tensor {name!r} ({kind} {list(shape)}, {want} bytes) has data_offsets "
                             f"[{begin}, {end}) in a data section of {n_data} bytes")
        arr = data[begin:end].view(np_dtype).reshape(shape)
        if not arr.flags.aligned:  # a writer that did not align its tensors: copy this one
            arr = arr.copy()
        t = torch.from_numpy(arr)
        out[name] = t.view(view_as) if view_as is not None else t
    return out
