"""The architecture family of a configuration, as a file of its own.

A configuration file names its family in ``family`` (``dense`` without the
key); the family is ``bench/families/<family>.py``, loaded by that name
through ``cell.module``, as an attention and a per-layer metric are.  A
family module gives:

* ``check(model, cfg)``: holds the program's configuration ``cfg`` to every
  size and choice the configuration file ``model`` states (``SystemExit``
  where they differ);
* ``layout(model)``: [(path, shape, init)] of the parameters in the
  program's tree, which ``weights.draw`` fills from the seed;
* ``logits(params, model, tokens, prec)`` and ``loss(params, model, tokens,
  labels, prec)``: the plain float32 reference, its layers' parameters on
  any devices (the activations follow them by ``.to()``);
* ``small(model, size)`` and ``small_program(model, size)``: the
  configuration file and the program's configuration cut to a size the
  harness's CPU tests run (``"tiny"``, and ``"control"``, where the float8
  control is read on the CPU).

What every family shares stays in ``weights`` (``draw``), ``reference``
(the float32 context, the float8 rounding, ``grads``, ``adamw``) and
``checks``.
"""

from __future__ import annotations

from types import ModuleType

from harness import cell

FAMILIES = cell.ROOT / "bench" / "families"
DEFAULT = "dense"


def name(model: dict) -> str:
    return model.get("family", DEFAULT)


def of(model: dict) -> ModuleType:
    """The module of ``model``'s family; an unknown family raises
    ``ValueError`` naming it."""
    fam = name(model)
    mod = cell.module(FAMILIES / f"{fam}.py")
    if mod is None:
        raise ValueError(f"unknown family {fam!r}: the benchmark has no "
                         f"bench/families/{fam}.py")
    return mod
