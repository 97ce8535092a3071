"""The weight bridge between the JAX package's flax parameter tree and the
port's ``state_dict``.

Names map one to one, ``/`` to ``.`` (``gru/uh`` <-> ``gru.uh``). A flax
``Dense`` (a node holding ``kernel`` and ``bias``) becomes an ``nn.Linear``:
its ``kernel`` [in, out] is the transpose of ``weight`` [out, in]. Every
other leaf keeps its layout, so the round trip is exact.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_flax(tree: Mapping[str, Any], prefix: str = ""
                     ) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (flax ``params``) -> float32 ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        key = f"{prefix}{name}"
        if isinstance(node, Mapping):
            if "kernel" in node:  # a Dense
                if set(node) - {"kernel", "bias"}:
                    raise ValueError(f"{key}: unexpected Dense leaves "
                                     f"{sorted(node)}")
                out[f"{key}.weight"] = _tensor(node["kernel"]).t().contiguous()
                if "bias" in node:
                    out[f"{key}.bias"] = _tensor(node["bias"])
            else:
                out.update(params_from_flax(node, f"{key}."))
        else:
            out[key] = _tensor(node)
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Any]:
    """``state_dict`` -> nested dict of numpy arrays in the flax layout."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        arr = value.detach().cpu().numpy()
        if parts[-1] == "weight":  # an nn.Linear
            parts[-1], arr = "kernel", np.ascontiguousarray(arr.T)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))
