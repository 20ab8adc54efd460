"""The plain reference of each configuration ``kind``: ``reference/<kind>.py``
(its tower, projector and prompt) over ``common.py`` (preprocessing, weight
rounding, the decoder with FrameFusion). Imports nothing of the program."""

import importlib


def load(kind: str):
    return importlib.import_module(f"{__name__}.{kind}")
