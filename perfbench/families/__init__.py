"""Model families that bring their own yardstick, each a file of its own.

A model's sizes that carry ``"family": "<name>"`` are taken by the
benchmark through ``families/<name>.py``, found by name, in place of the
three families that ``weights``, ``reference`` and ``counting`` hold
(``dense``, ``moe``, ``ssm``).  Sizes with no ``family`` key run those.

A family module gives:

* ``layout(m)``: the leaves ``{dotted path: (shape, dtype, init)}``, held
  to the program's ``param_spec`` as ``weights.layout`` is;
* ``forward(m, w, tokens, want, *, fp8=False, routing=False)``: the plain
  reference, on ``reference.forward``'s contract (float32 logits at
  ``want``; with ``routing``, what ``experts_read`` reads), in plain
  ``torch`` with TF32 off;
* ``experts_read(m, routes, rows, steps)``: of one task, whose rows are
  ``rows`` (a slice) of the block that ``forward`` routed, an int64
  array (MoE layers, ``steps``) of the distinct experts each step reads;
  a layer that holds a share of the experts counts only its own.  None
  where the family routes nothing;
* ``step_flops(m, b, pos)`` and ``step_bytes(m, b, pos, experts)``: on
  ``counting``'s contracts, ``experts`` being one column of that array;
* ``reduced(m, dtype)``: the sizes of the CPU tests' small stand-in.

A family file may build on the yardstick's own helpers (``reference``'s
``_mm``, ``_rms``, ``_rope``, ``_swiglu``, ``_attention``, ``_layer``,
``_clamped``; ``counting``'s peaks and ``ITEMSIZE``), and imports nothing
of the program.  It is part of the frozen yardstick: a later change adds
a family as a new file and edits none.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict, Mapping, Optional

#: Where the family files lie.
DIR = Path(__file__).resolve().parent
_LOADED: Dict[Path, ModuleType] = {}


def load(name: str) -> ModuleType:
    """The family module ``<DIR>/<name>.py``, loaded once a path."""
    path = DIR / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no family file {path}")
        spec = importlib.util.spec_from_file_location(f"perfbench_family_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def of(sizes: Mapping) -> Optional[ModuleType]:
    """The family module a model's ``sizes`` name, or None."""
    name = sizes.get("family")
    return None if name is None else load(name)
