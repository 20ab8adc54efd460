"""The port has every public name of the JAX package.

For each module ``framefusion_tpu/<path>.py`` this reads, with ``ast``, the
public top-level functions and classes and each class's public methods,
imports the port's module at the same path (``native/__init__.py`` is the
port's ``native.py``) and looks each name up with ``getattr``, which finds
inherited methods too. A name the port keeps elsewhere stands in
``MOVED`` (JAX module:name -> the port's module:name); a name the port
does not have stands in ``NOT_PORTED`` with the reason. Any other missing
name fails, and so do a ``NOT_PORTED`` entry that the port now defines and
a ``MOVED`` entry whose target is not there.
"""

import ast
import importlib
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_ROOT = ROOT / "framefusion_tpu"

MOVED = {
    "parallel/pipeline.py:pipe_param_pspecs": "parallel/sharding.py:pipe_param_pspecs",
}
NOT_PORTED = {
    "ops/attention.py:causal_attention_chunked": (
        "JAX's memory-bounded attention for backends other than the TPU; the port's CPU path is the plain "
        "einsum and the card runs kernels A and F (causal_attention(impl='chunked') raises)"),
}


def _jax_modules() -> list:
    return sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py"))


def _port_module(rel: str):
    parts = list(Path(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return importlib.import_module(".".join(["framefusion_tpu_torch", *parts]))


def _public_names(rel: str) -> list:
    tree = ast.parse((JAX_ROOT / rel).read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and not m.name.startswith("_")]
    return names


def _has(module, dotted: str) -> bool:
    obj = module
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def _target(entry: str) -> tuple:
    rel, name = entry.split(":")
    return _port_module(rel), name


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_is_ported(rel):
    names = _public_names(rel)
    if not names:
        return
    module = _port_module(rel)
    missing = [n for n in names if f"{rel}:{n}" not in MOVED and f"{rel}:{n}" not in NOT_PORTED
               and not _has(module, n)]
    assert not missing, f"framefusion_tpu/{rel}: not in {module.__name__}: {missing}"


def test_exceptions_are_still_exceptions():
    for entry in NOT_PORTED:
        module, name = _target(entry)
        assert not _has(module, name), f"{entry} is ported now: take it out of NOT_PORTED"
        rel = entry.split(":")[0]
        assert name in _public_names(rel), f"{entry}: the JAX package has no such name"
    for entry, target in MOVED.items():
        rel, name = entry.split(":")
        assert name in _public_names(rel), f"{entry}: the JAX package has no such name"
        module, port_name = _target(target)
        assert _has(module, port_name), f"{entry} -> {target}: the port has no such name"


def test_the_walk_sees_the_package():
    """The walk reaches the subpackages and reads methods: a public name of
    each kind is found where the JAX package defines it."""
    rels = _jax_modules()
    assert {"native/__init__.py", "ops/kernels/flash_prefill.py", "runtime/profiling.py",
            "parallel/sharding.py"} <= set(rels)
    assert "CompressionEngine.prefill_planned" in _public_names("runtime/engine.py")
    assert "BaselineEngine.generate_greedy" in _public_names("baselines/qwen2_baselines.py")
    assert _port_module("native/__init__.py").__name__ == "framefusion_tpu_torch.native"
