"""Mixed precision (``paddle_tpu/amp/auto_cast.py`` counterpart).

Only :func:`decorate` at level ``"O2"`` is ported so far: it casts every
floating-point parameter and buffer of the models to the AMP dtype (the
flag ``amp_dtype``, bfloat16 by default, as in JAX), and ``master_weight``
sets the optimizers' ``multi_precision`` (float32 masters, on by default).
Level ``"O1"``, its op lists and ``auto_cast`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def decorate(models, optimizers=None, level: str = "O2",
             dtype: Optional[str] = None,
             master_weight: Optional[bool] = None,
             save_dtype: Optional[str] = None):
    """``paddle.amp.decorate`` at O2: cast the models' parameters to the
    AMP dtype. Returns ``models`` or ``(models, optimizers)``, each as
    given (one object or a list)."""
    if level == "O1":
        raise NotImplementedError(
            "AMP O1 needs auto_cast and its op lists, which are not ported "
            "yet (ROADMAP Queue 1)")
    if level != "O2":
        raise ValueError(f"level must be 'O2'; got {level!r}")
    from ..core import flags
    dtype = dtype or flags.flag("amp_dtype")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}; got "
                         f"{dtype!r}")
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        m.to(_DTYPES[dtype])
    if optimizers is None:
        return models if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    if master_weight is not None:
        for o in opt_list:
            o.multi_precision = bool(master_weight)
    return (models if single else model_list,
            optimizers if opt_single else opt_list)
