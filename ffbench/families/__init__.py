"""The program under test, one module a configuration ``kind``.

``families/<kind>.py`` builds the port's served path for a configuration
file (``build``: the seeded weights, the port's own set-up of them, its
``TextPipeline``) and states the tower's work from its shapes
(``tower_work``). It may define ``counters(program)``, a dict of the
program's host numbers: a traced run reads it at the window's open and
close, and readers get the difference as ``run.counters``. ``common.py``
holds what the decoders share.
"""

import importlib


def load(kind: str):
    return importlib.import_module(f"{__name__}.{kind}")
