"""The plain reference of each configuration ``kind``: ``reference/<kind>.py``
(its tower, projector and prompt, and, where it defines one, its decoder)
over ``common.py`` (preprocessing, weight rounding, the decoder with
FrameFusion). Imports nothing of the program."""

import importlib


def load(kind: str):
    return importlib.import_module(f"{__name__}.{kind}")


def decoder(config: dict, seed: int, device, precision):
    """The reference decoder of ``config``'s kind at ``precision``: what
    ``reference/<kind>.py``'s ``decoder(config, seed, device, precision)``
    returns, or ``common.dense_decoder``'s for a kind that defines none.
    It offers ``embed(ids)`` and ``forward(prompts, served, ff)``, one
    (logits, events) a prompt (``common.Decoder``)."""
    from . import common

    make = getattr(load(config["kind"]), "decoder", common.dense_decoder)
    return make(config, seed, device, precision)
