"""Parameter files of the port: a ``state_dict`` saved with ``torch.save``.

A JAX run's ``params_final/`` is an Orbax checkpoint directory, which
cannot be read without JAX. Bring one over by loading it with the JAX
package's own ``utils.checkpoint.load_params`` and passing its ``params``
through :func:`vqa_transfer_externaldata_torch.utils.convert.params_from_flax`,
then :func:`save_params`.
"""

from __future__ import annotations

import os
from typing import Dict

import torch


def save_params(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write ``state_dict`` (moved to the CPU) to ``path`` atomically."""
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    tmp = f"{path}.tmp"
    torch.save(cpu, tmp)
    os.replace(tmp, path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` saved at ``path``, on the CPU."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an Orbax checkpoint of the JAX package, "
            "which cannot be read without JAX. Load it with "
            "vqa_transfer_externaldata_tpu.utils.checkpoint.load_params, "
            "convert its 'params' with utils.convert.params_from_flax and "
            "write them with utils.checkpoint.save_params")
    return torch.load(path, map_location="cpu", weights_only=True)
