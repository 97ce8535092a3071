"""The weight bridge between the JAX package's flax variables and the
port's ``state_dict``.

Names map one to one, ``/`` to ``.`` (``gru/uh`` <-> ``gru.uh``,
``resnet/layer3_0/conv2/kernel`` <-> ``resnet.layer3_0.conv2.weight``). A
flax node holding ``kernel`` is a ``Dense`` or a ``Conv``: a Dense's
``kernel`` [in, out] is the transpose of the ``nn.Linear`` ``weight``
[out, in], a conv's 4-D ``kernel`` (HWIO) is the OIHW ``weight``
permuted. Every other leaf keeps its layout (a BatchNorm's ``scale`` and
``bias`` too), so the round trip is exact.

A BatchNorm's statistics live in flax's ``batch_stats`` collection
(``mean``/``var``) and in the port's buffers of the same names:
:func:`batch_stats_from_flax` and :func:`batch_stats_to_flax` carry them,
and :func:`params_to_flax` leaves them out of the ``params`` tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# The leaf names of flax's batch_stats collection (the port's buffers).
BATCH_STATS = ("mean", "var")


def params_from_flax(tree: Mapping[str, Any], prefix: str = ""
                     ) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (flax ``params``) -> float32 ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        key = f"{prefix}{name}"
        if isinstance(node, Mapping):
            if "kernel" in node:  # a Dense or a Conv
                if set(node) - {"kernel", "bias"}:
                    raise ValueError(f"{key}: unexpected Dense leaves "
                                     f"{sorted(node)}")
                kernel = _tensor(node["kernel"])
                if kernel.dim() == 4:  # HWIO -> OIHW
                    weight = kernel.permute(3, 2, 0, 1)
                else:
                    weight = kernel.t()
                out[f"{key}.weight"] = weight.contiguous()
                if "bias" in node:
                    out[f"{key}.bias"] = _tensor(node["bias"])
            else:
                out.update(params_from_flax(node, f"{key}."))
        else:
            out[key] = _tensor(node)
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Any]:
    """``state_dict`` -> nested dict of numpy arrays in the flax ``params``
    layout; BatchNorm statistics (:data:`BATCH_STATS` leaves) are left out
    (:func:`batch_stats_to_flax` takes them)."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[-1] in BATCH_STATS:
            continue
        arr = value.detach().cpu().numpy()
        if parts[-1] == "weight":  # an nn.Linear, or a conv if 4-D
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            parts[-1], arr = "kernel", np.ascontiguousarray(arr)
        _put(tree, parts, arr)
    return tree


def batch_stats_from_flax(tree: Mapping[str, Any], prefix: str = ""
                          ) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (flax ``batch_stats``) -> float32 buffers of
    the port, named as the parameters are (``resnet.bn1.mean``)."""
    out: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        key = f"{prefix}{name}"
        if isinstance(node, Mapping):
            out.update(batch_stats_from_flax(node, f"{key}."))
        elif name in BATCH_STATS:
            out[key] = _tensor(node)
        else:
            raise ValueError(f"{key}: not a batch statistic "
                             f"({'/'.join(BATCH_STATS)})")
    return out


def batch_stats_to_flax(state_dict: Mapping[str, torch.Tensor]
                        ) -> Dict[str, Any]:
    """The :data:`BATCH_STATS` entries of ``state_dict`` -> flax's nested
    ``batch_stats`` dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[-1] in BATCH_STATS:
            _put(tree, parts, value.detach().cpu().numpy())
    return tree


def _put(tree: Dict[str, Any], parts, arr: np.ndarray) -> None:
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = arr


def _tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))
