"""Parameter files of the port (a ``state_dict`` saved with ``torch.save``)
and the cross-stage transfer: a stage-1 word table into a stage-2 model's
word table and answer classifier.

A JAX run's ``params_final/`` is an Orbax checkpoint directory, which
cannot be read without JAX. Bring one over by loading it with the JAX
package's own ``utils.checkpoint.load_params`` and passing its ``params``
through :func:`vqa_transfer_externaldata_torch.utils.convert.params_from_flax`,
then :func:`save_params`.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from vqa_transfer_externaldata_torch.utils.logging import log
from vqa_transfer_externaldata_torch.utils.vocab import Vocab, tokenize


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


def answer_embedding_from_words(word_table: np.ndarray, word_vocab: Vocab,
                                answer_vocab: Vocab, fallback: np.ndarray
                                ) -> np.ndarray:
    """``fallback`` [A, D] (the model's freshly initialized answer table)
    with row a replaced by the mean word embedding of answer a's tokens,
    for each of the first A answers that has a known word."""
    out = np.array(fallback, np.float32)
    for a, answer in enumerate(answer_vocab.tokens[:len(out)]):
        ids = [word_vocab.token_to_id[t] for t in tokenize(answer)
               if t in word_vocab.token_to_id]
        if ids:
            out[a] = word_table[ids].mean(axis=0)
    return out


def _resolve_unique(state: Dict[str, torch.Tensor], name: str, *,
                    who: str) -> str:
    """The one key of ``state`` whose dotted path ends in ``name`` (a
    suffix of whole components)."""
    keys = [k for k in state if k == name or k.endswith("." + name)]
    if not keys:
        tops = sorted({k.split(".")[0] for k in state})
        raise ValueError(
            f"transfer_init: no {name!r} in the {who} parameters "
            f"(top-level names: {tops}); this model does not expose the "
            f"shared word space, so stage-1 transfer cannot apply")
    if len(keys) > 1:
        raise ValueError(
            f"transfer_init: {name!r} is ambiguous in the {who} "
            f"parameters: {keys}")
    return keys[0]


def transfer_init(vqa_params: Dict[str, torch.Tensor],
                  vlmap_params: Dict[str, torch.Tensor], word_vocab: Vocab,
                  answer_vocab: Vocab) -> Dict[str, torch.Tensor]:
    """Map stage-1 parameters into a freshly initialized stage-2
    ``state_dict`` (a new dict; the inputs are not changed):

    - ``word_emb.embedding`` is copied verbatim (the shared word space);
    - the ``answer_embedding`` rows are rebuilt from that word table by
      :func:`answer_embedding_from_words`, answers with no known word
      keeping their fresh rows.

    Everything else keeps its fresh value. Both tables are found by name,
    wherever they are nested, and both must be there."""
    src_key = _resolve_unique(vlmap_params, "word_emb.embedding",
                              who="stage-1")
    tgt_key = _resolve_unique(vqa_params, "word_emb.embedding",
                              who="stage-2")
    ans_key = _resolve_unique(vqa_params, "answer_embedding", who="stage-2")
    src = vlmap_params[src_key].detach().cpu()
    tgt = vqa_params[tgt_key]
    if tuple(src.shape) != tuple(tgt.shape):
        raise ValueError(f"word table shape mismatch: vlmap "
                         f"{tuple(src.shape)} vs vqa {tuple(tgt.shape)}")
    tgt_ans = vqa_params[ans_key].detach().cpu().float().numpy()
    if src.shape[1] != tgt_ans.shape[1]:
        raise ValueError(
            f"answer embedding dim mismatch: words give {src.shape[1]}, "
            f"model has {tgt_ans.shape[1]} (set model.answer_dim = word_dim "
            "for transfer)")
    ans = answer_embedding_from_words(src.float().numpy(), word_vocab,
                                      answer_vocab, fallback=tgt_ans)
    out = dict(vqa_params)
    out[tgt_key] = src.to(tgt.dtype).clone()
    out[ans_key] = torch.from_numpy(ans).to(vqa_params[ans_key].dtype)
    log.info("transfer_init: word table %s copied, %d answer rows seeded",
             tuple(src.shape), min(len(answer_vocab), len(ans)))
    return out
