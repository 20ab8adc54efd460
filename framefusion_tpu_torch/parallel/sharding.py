"""Tensor-parallel sharding of the Qwen2 stack (port of
``framefusion_tpu.parallel.sharding``).

JAX puts the parameters on a ``(data, tensor)`` mesh with ``NamedSharding``
and GSPMD inserts the collectives. Here each rank holds its own contiguous
shard of every sharded leaf (``shard_params``) and runs the same model
functions over a local config (``local_config``: heads, KV heads and the
MLP inner width divided by the tensor width); the collectives are explicit
in the model functions and scoped to the engine (``parallel/collectives``):
one sum after each row-split product (``wo``, ``w_down``, the MoE
combine), a masked lookup and a sum for the vocabulary-split embedding, a
gather of the head's vocabulary slices, and the prune importance's mean
over all heads.

``param_pspecs(cfg)`` is JAX's table, leaf for leaf, as tuples of axis
names (``("tensor"`` where JAX's ``PartitionSpec`` names it, else None)):
q / k / v, their biases, gate / up and the head split by output column;
``wo`` and ``w_down`` by input row; the embedding by vocabulary row; a MoE
stack's expert axis takes the tensor slot, its shared expert splits like a
dense MLP and its router and shared gate are whole. An int8 pair ``{"q8",
"scale"}`` splits its q8 like the dense leaf and its column scales with the
columns (whole where the rows split).

``pipe_param_pspecs(cfg)`` is JAX's pipeline table: the layer stack split
over ``stage`` along its layer axis, everything else whole.
``shard_axis(mesh)`` is the one place a mesh's kind is read: the split
axis (``tensor``, ``expert`` or ``stage``), this rank's place on it and on
``data``, the layers it holds and its rows of a batch (``ShardAxis``).

``init_sharded_params`` draws random weights one (leaf, layer) at a time
from the shared seed and keeps only the rank's shard, so no rank ever holds
a whole stack; with no mesh it draws the same weights whole.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import torch

from ..config import LLMConfig
from ..models.moe import moe_pspecs
from . import collectives

_COL, _ROW = (None, None, "tensor"), (None, "tensor", None)


def make_mesh(world: Optional[int] = None, tensor: Optional[int] = None):
    """A ``(data, tensor)`` DeviceMesh over the process group's ranks, with
    JAX's factorisation: ``tensor`` defaults to min(4, world), halved until it
    divides the world. Its device type is ``mesh_device_type()``'s."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if world is None else world
    if tensor is None:
        tensor = min(4, world)
        while world % tensor:
            tensor //= 2
    if world % tensor:
        raise ValueError(f"{world} ranks not divisible by tensor={tensor}")
    return init_device_mesh(mesh_device_type(), (world // tensor, tensor), mesh_dim_names=("data", "tensor"))


def mesh_device_type() -> str:
    """A mesh's device type for the process group's backend: "cuda" under
    NCCL, "cpu" under gloo (whose groups take CPU tensors; CUDA tensors are
    staged through the host)."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


@dataclasses.dataclass(frozen=True)
class ShardAxis:
    """A rank's place on a mesh: the axis the mesh splits the model over,
    ``"tensor"`` (a ``(data, tensor)`` mesh, ``param_pspecs``), ``"expert"``
    (a ``(data, expert)`` one, ``moe_pspecs``) or ``"stage"`` (a pipeline's
    ``(data, stage)`` one, ``pipe_param_pspecs``: a contiguous block of
    layers), this rank's place on it and its width, and its place on the
    ``data`` axis. Built by ``shard_axis(mesh)``, or directly for a rank's
    layout without a process group."""

    axis: str
    rank: int
    width: int
    data_rank: int = 0
    data_width: int = 1

    def specs(self, cfg: LLMConfig) -> dict:
        """The stack's axis names for this split: ``param_pspecs(cfg)``, the
        expert stacks' ``moe_pspecs`` (a layer axis in front, every other
        leaf whole) or ``pipe_param_pspecs(cfg)``."""
        if self.axis == "tensor":
            return param_pspecs(cfg)
        if self.axis == "stage":
            return pipe_param_pspecs(cfg)
        if not cfg.is_moe:
            raise ValueError("an expert mesh shards a MoE stack")
        return {"layers": {k: (None,) + v for k, v in moe_pspecs().items()}}

    def layers(self, cfg: LLMConfig) -> tuple:
        """``(first layer, layer count)`` this rank holds: its stage's block
        on a ``stage`` axis, else the whole stack."""
        if self.axis != "stage":
            return 0, cfg.num_layers
        if cfg.num_layers % self.width:
            raise ValueError(f"{cfg.num_layers} layers do not split over {self.width} stages")
        per = cfg.num_layers // self.width
        return self.rank * per, per

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of the rows of ``ids`` over the
        ``data`` axis (JAX's ``P("data", None)``)."""
        n = self.data_width
        if ids.shape[0] % n:
            raise ValueError(f"a batch of {ids.shape[0]} rows does not split over {n} data ranks")
        per = ids.shape[0] // n
        return ids[self.data_rank * per:(self.data_rank + 1) * per]


def shard_axis(mesh) -> ShardAxis:
    """``mesh``'s ``tensor``, ``expert`` or ``stage`` axis and its ``data``
    axis (``ShardAxis``); a ``ShardAxis`` is returned as it is."""
    if isinstance(mesh, ShardAxis):
        return mesh
    names = mesh.mesh_dim_names
    data = {}
    if "data" in names:
        dim = names.index("data")
        data = dict(data_rank=mesh.get_local_rank(dim), data_width=mesh.size(dim))
    for axis in ("tensor", "expert", "stage"):
        if axis in names:
            dim = names.index(axis)
            return ShardAxis(axis, mesh.get_local_rank(dim), mesh.size(dim), **data)
    raise ValueError(f"a mesh with a 'tensor', an 'expert' or a 'stage' axis, got {names}")


def param_pspecs(cfg: LLMConfig) -> dict:
    """JAX's ``param_pspecs``: each leaf's axis names, ``"tensor"`` on the
    split axis (module docstring)."""
    layers = {"ln1": (None, None), "ln2": (None, None), "wq": _COL, "wk": _COL, "wv": _COL,
              "bq": (None, "tensor"), "bk": (None, "tensor"), "bv": (None, "tensor"), "wo": _ROW,
              "w_gate": _COL, "w_up": _COL, "w_down": _ROW}
    specs = {"embed": ("tensor", None), "layers": layers, "final_norm": (None,), "lm_head": (None, "tensor")}
    if not cfg.qkv_bias:
        for k in ("bq", "bk", "bv"):
            layers.pop(k)
    if cfg.is_moe:
        for k in ("w_gate", "w_up", "w_down"):
            layers[k] = (None, "tensor", None, None)
        layers.update({"router": (None, None, None), "sw_gate": _COL, "sw_up": _COL, "sw_down": _ROW,
                       "shared_gate": (None, None, None)})
    if cfg.tie_word_embeddings:
        specs.pop("lm_head")
    return specs


def param_shardings(cfg: LLMConfig, mesh) -> dict:
    """JAX's ``param_shardings``: each leaf of the split's table
    (``ShardAxis.specs``: ``param_pspecs`` on a ``(data, tensor)`` mesh) as
    its placement on ``mesh`` (a DeviceMesh, or a ``ShardAxis``), a tuple
    of ``torch.distributed.tensor`` placements a mesh dimension, ``data``
    first: ``Shard(dim)`` on the split axis for a leaf that splits along
    ``dim``, ``Replicate()`` otherwise. ``shard_params`` gives each rank
    its block of those dims (the vocabulary padded first under TP)."""
    from torch.distributed.tensor import Replicate, Shard

    ax = shard_axis(mesh)

    def place(spec):
        if isinstance(spec, dict):
            return {k: place(v) for k, v in spec.items()}
        return Replicate(), Shard(spec.index(ax.axis)) if ax.axis in spec else Replicate()

    return place(ax.specs(cfg))


def pipe_param_pspecs(cfg: LLMConfig) -> dict:
    """JAX's ``pipe_param_pspecs``: the layer stack split over ``stage``
    along its layer axis, everything else whole."""
    two, three = ("stage", None), ("stage", None, None)
    layers = {"ln1": two, "ln2": two, "wq": three, "wk": three, "wv": three, "bq": two, "bk": two, "bv": two,
              "wo": three, "w_gate": three, "w_up": three, "w_down": three}
    if not cfg.qkv_bias:
        for k in ("bq", "bk", "bv"):
            layers.pop(k)
    specs = {"embed": (None, None), "layers": layers, "final_norm": (None,)}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, None)
    return specs


def local_config(cfg: LLMConfig, tensor: int) -> LLMConfig:
    """The config a rank's shard computes with: heads, KV heads and the MLP
    inner widths divided by ``tensor`` (the head dim made explicit); the
    vocabulary and the expert count stay global (the head's slices are
    gathered, and every rank routes over every expert). Raises where a width
    does not divide."""
    need = {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads}
    if cfg.is_moe:
        need.update(num_experts=cfg.num_experts, shared_expert_intermediate_size=cfg.shared_expert_intermediate_size)
    else:
        need["intermediate_size"] = cfg.intermediate_size
    bad = {k: v for k, v in need.items() if v % tensor}
    if bad:
        raise ValueError(f"tensor={tensor} does not divide {bad}")
    kw = dict(num_heads=cfg.num_heads // tensor, num_kv_heads=cfg.num_kv_heads // tensor, head_dim=cfg.head_dim_)
    if cfg.is_moe:
        kw["shared_expert_intermediate_size"] = cfg.shared_expert_intermediate_size // tensor
    else:
        kw["intermediate_size"] = cfg.intermediate_size // tensor
    return cfg.replace(**kw)


def _axis_of(spec: tuple, axis: str) -> Optional[int]:
    return spec.index(axis) if axis in spec else None


def _pad_to(x: torch.Tensor, dim: int, multiple: int, value: float = 0.0) -> torch.Tensor:
    pad = -x.shape[dim] % multiple
    if not pad:
        return x
    widths = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [0, pad]
    return torch.nn.functional.pad(x, widths, value=value)


def _slice(x: torch.Tensor, dim: Optional[int], rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous block of ``n`` along ``dim`` (a copy of
    its own, so 16-byte aligned), or ``x`` itself for a whole leaf."""
    if dim is None:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"axis {dim} of {tuple(x.shape)} does not split over {n} ranks")
    return x.narrow(dim, rank * (size // n), size // n).contiguous()


def shard_leaf(x, spec: tuple, rank: int, n: int, axis: str = "tensor"):
    """One leaf's shard: a dense tensor along the axis ``spec`` names, an
    int8 pair's q8 likewise and its scales (the q8's last axis dropped)
    with the columns or the experts, whole where the rows split."""
    dim = _axis_of(spec, axis)
    if not isinstance(x, dict):
        return _slice(x, dim, rank, n)
    q_nd = x["q8"].ndim
    scale_dim = None if dim is None or dim == q_nd - 2 else (dim if dim < q_nd - 2 else dim - 1)
    return {"q8": _slice(x["q8"], dim, rank, n), "scale": _slice(x["scale"], scale_dim, rank, n)}


def _pad_vocab(params: dict, cfg: LLMConfig, n: int) -> dict:
    """The embedding's rows and the head's columns padded to a multiple of
    the ranks (an int8 head's to 16 a rank, the kernel's vector width): pad
    rows are never looked up and pad columns' logits are sliced off."""
    out = dict(params)
    out["embed"] = _pad_to(params["embed"], 0, n)
    head = params.get("lm_head")
    if isinstance(head, dict):
        out["lm_head"] = {"q8": _pad_to(head["q8"], 1, 16 * n), "scale": _pad_to(head["scale"], 0, 16 * n, 1e-12)}
    elif head is not None:
        out["lm_head"] = _pad_to(head, 1, n)
    return out


def shard_params(params: dict, cfg: LLMConfig, mesh) -> dict:
    """This rank's shard of ``params`` over ``mesh``'s ``tensor`` axis
    (``param_pspecs``), over its ``expert`` axis (``moe_pspecs`` on a MoE
    stack: the expert stacks split, everything else whole) or over its
    ``stage`` axis (``pipe_param_pspecs``: the stage's block of layers,
    everything else whole). ``mesh`` may be a ``ShardAxis``."""
    ax = shard_axis(mesh)
    specs = ax.specs(cfg)
    ax.layers(cfg)  # a stage split refuses layers that do not split
    if ax.axis == "tensor":
        params = _pad_vocab(params, cfg, ax.width)

    def walk(tree, spec):
        if isinstance(tree, dict) and not {"q8", "scale"} <= tree.keys():
            return {k: walk(v, spec.get(k) if isinstance(spec, dict) else None) for k, v in tree.items()}
        return tree if spec is None else shard_leaf(tree, spec, ax.rank, ax.width, ax.axis)

    return walk(params, specs)


def mesh_scope(mesh) -> collectives.Scope:
    """The collectives scope of an engine over ``mesh``: the tensor group
    (also the expert group: JAX puts the expert axis in the tensor slot) of
    a ``(data, tensor)`` mesh, the expert group of a ``(data, expert)``
    one."""
    ax = shard_axis(mesh)
    g = collectives.Group(mesh.get_group(ax.axis))
    return collectives.Scope(tensor=g, expert=g) if ax.axis == "tensor" else collectives.Scope(expert=g)


# ---------------------------------------------------------------------------
# Random weights drawn a shard at a time


def _seed(seed: int, name: str, layer: int) -> int:
    digest = hashlib.sha256(f"{seed}/{name}/{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def init_sharded_params(cfg: LLMConfig, seed: int, mesh=None, *, device=None, int8: bool = False,
                        quantize_lm_head: bool = False) -> dict:
    """Random-normal weights (scale 0.02, as ``qwen2.init_params``; norms 1,
    biases 0), each (leaf,
    layer) matrix drawn from a generator of its own seeded from ``seed``,
    on ``device`` (the card by default) in ``cfg.dtype``. ``int8``
    quantizes each drawn matrix (``ops/quant.quantize_weight``; the head too
    with ``quantize_lm_head``, padded as ``quantize_head`` pads it): a
    row-split leaf before it is split (its scales need the whole columns),
    any other after.
    With ``mesh`` (or a ``ShardAxis``) only this rank's shard of each
    matrix is kept (``shard_params``'s split; on a pipeline's ``(data,
    stage)`` mesh the stage's layers, each drawn by its global index, and
    the rest whole), so the peak beyond the shard is one layer's matrix;
    without, the whole stack: the same weights on every layout."""
    from ..ops.quant import quantize_head, quantize_weight
    from ..weights import resolve_device

    device = resolve_device(device)
    hd, d = cfg.head_dim_, cfg.hidden_size
    hq, hk = cfg.num_heads * hd, cfg.num_kv_heads * hd
    shapes = {"wq": (d, hq), "wk": (d, hk), "wv": (d, hk), "wo": (hq, d)}
    if cfg.is_moe:
        e, mi, si = cfg.num_experts, cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size
        shapes.update({"router": (d, e), "w_gate": (e, d, mi), "w_up": (e, d, mi), "w_down": (e, mi, d),
                       "sw_gate": (d, si), "sw_up": (d, si), "sw_down": (si, d), "shared_gate": (d, 1)})
    else:
        i = cfg.intermediate_size
        shapes.update({"w_gate": (d, i), "w_up": (d, i), "w_down": (i, d)})
    whole = {"router", "shared_gate"}  # never quantized, as quantize_params_int8 leaves them

    ax = ShardAxis("tensor", 0, 1) if mesh is None else shard_axis(mesh)
    axis, rank, n = ax.axis, ax.rank, ax.width
    first, n_l = ax.layers(cfg)
    specs = {} if mesh is None or axis == "stage" else ax.specs(cfg)  # a stage's layers are whole
    lspecs = specs.get("layers", {})

    def draw(name, layer, shape):
        gen = torch.Generator(device=device).manual_seed(_seed(seed, name, layer))
        return torch.randn(shape, generator=gen, device=device, dtype=cfg.dtype).mul_(0.02)

    layers = {}
    for name, shape in shapes.items():
        spec = lspecs.get(name)
        parts = []
        quant = int8 and name not in whole
        # A row split needs the whole columns' scales: quantize, then split;
        # any other split quantizes the shard alone (the same numbers).
        rows_split = spec is not None and _axis_of(spec[1:], axis) == len(shape) - 2
        for l in range(first, first + n_l):
            w = draw(name, l, shape)
            if spec is not None and not (quant and rows_split):
                w = shard_leaf(w, spec[1:], rank, n, axis)
            if quant:
                w = quantize_weight(w)
            if spec is not None and quant and rows_split:
                w = shard_leaf(w, spec[1:], rank, n, axis)
            parts.append(w)
            del w
        if isinstance(parts[0], dict):
            layers[name] = {k: torch.stack([p[k] for p in parts]) for k in ("q8", "scale")}
        else:
            layers[name] = torch.stack(parts)
        del parts

    def const(value, *shape):
        return torch.full(shape, value, device=device, dtype=cfg.dtype)

    def sharded(name, t):
        spec = lspecs.get(name)
        return t if spec is None else shard_leaf(t, spec, rank, n, axis)

    layers["ln1"], layers["ln2"] = const(1.0, n_l, d), const(1.0, n_l, d)
    if cfg.qkv_bias:
        layers.update(bq=sharded("bq", const(0.0, n_l, hq)), bk=sharded("bk", const(0.0, n_l, hk)),
                      bv=sharded("bv", const(0.0, n_l, hk)))
    embed = draw("embed", 0, (cfg.vocab_size, d))
    params = {"embed": embed, "layers": layers, "final_norm": const(1.0, d)}
    if not cfg.tie_word_embeddings:
        head = draw("lm_head", 0, (d, cfg.vocab_size))
        params["lm_head"] = quantize_head(head) if quantize_lm_head else head
        del head
    if axis == "tensor" and n > 1:
        params = _pad_vocab(params, cfg, n)
        params["embed"] = shard_leaf(params["embed"], specs["embed"], rank, n)
        if "lm_head" in params:
            params["lm_head"] = shard_leaf(params["lm_head"], specs["lm_head"], rank, n)
    return params
