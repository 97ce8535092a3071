"""Training checkpoints of the port (``CheckpointManager``, torch files in
the run directory), its parameter files (a ``state_dict`` saved with
``torch.save``) and the cross-stage transfer: a stage-1 word table into a
stage-2 model's word table and answer classifier.

A JAX run's ``params_final/`` and ``ckpt/`` are Orbax checkpoint
directories, which cannot be read without JAX. Bring parameters over by
loading them with the JAX package's own ``utils.checkpoint.load_params`` and
passing its ``params`` through
:func:`vqa_transfer_externaldata_torch.utils.convert.params_from_flax`,
then :func:`save_params`.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from vqa_transfer_externaldata_torch.utils.logging import log
from vqa_transfer_externaldata_torch.utils.vocab import Vocab, tokenize


class CheckpointManager:
    """Periodic checkpoints of a training run, ``<train_dir>/ckpt/
    ckpt_<step>.pt``, with the JAX package's policy (Orbax's): a run's first
    save call writes, later ones every ``save_every`` steps, ``force``
    always; the newest ``keep`` stay. Each file is written atomically (a
    temporary file, then a rename) and holds what a resumed run needs to
    continue bit for bit: the parameters, the model's buffers (BatchNorm
    statistics, where it has any), the AdamW state (count, mu, nu), the
    step and the dropout generator's state. Saves are synchronous."""

    _NAME = re.compile(r"ckpt_(\d+)\.pt")

    def __init__(self, train_dir: str, *, keep: int = 5,
                 save_every: int = 1000) -> None:
        self.directory = os.path.abspath(os.path.join(train_dir, "ckpt"))
        os.makedirs(self.directory, exist_ok=True)
        self.keep = max(1, keep)
        self.save_every = max(1, save_every)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            self._NAME.fullmatch, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, *, force: bool = False) -> bool:
        """Write ``state`` (a trainer ``TrainState``) as step ``step`` when
        the policy says so; returns whether it wrote."""
        latest = self.latest_step()
        if not force and latest is not None and (
                latest >= step or step % self.save_every):
            return False
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
        opt = state.opt_state
        payload = {"step": int(step), "params": cpu(state.params),
                   "opt": {"count": int(opt.count), "mu": cpu(opt.mu),
                           "nu": cpu(opt.nu)},
                   "rng": state.rng.get_state()}
        buffers = getattr(state, "buffers", None)
        if buffers:
            payload["buffers"] = cpu(buffers)
        path = self._path(step)
        tmp = f"{path}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.keep]:
            os.remove(self._path(old))
        return True

    def restore(self, state, step: Optional[int] = None):
        """``state`` with the checkpoint of ``step`` (default: the latest)
        copied in: the parameters and buffers in place (they are the
        model's own), the optimizer moments on their devices, the
        generator's state."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._path(step)):
            raise FileNotFoundError(
                f"no checkpoint{'' if step is None else f' of step {step}'} "
                f"under {self.directory}")
        ck = torch.load(self._path(step), map_location="cpu",
                        weights_only=True)
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(ck["params"][k])
            for k, b in ck.get("buffers", {}).items():
                state.buffers[k].copy_(b)
        opt = state.opt_state
        moved = lambda d, like: {k: v.to(like[k].device) for k, v in d.items()}
        opt = dataclasses.replace(opt, count=ck["opt"]["count"],
                                  mu=moved(ck["opt"]["mu"], opt.mu),
                                  nu=moved(ck["opt"]["nu"], opt.nu))
        state.rng.set_state(ck["rng"])
        return dataclasses.replace(state, step=ck["step"], opt_state=opt)

    def save_data_iter(self, step: int, state: Dict) -> None:
        raise NotImplementedError(
            "input-iterator state (the grain pipeline) is not ported yet "
            "(ROADMAP.md, section 1, item 14)")

    def restore_data_iter(self, step: Optional[int] = None) -> Optional[Dict]:
        raise NotImplementedError(
            "input-iterator state (the grain pipeline) is not ported yet "
            "(ROADMAP.md, section 1, item 14)")


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
                    who: str, required: bool = True) -> Optional[str]:
    """The one key of ``state`` whose dotted path ends in ``name`` (a
    suffix of whole components); None when there is none and it is not
    ``required``."""
    keys = [k for k in state if k == name or k.endswith("." + name)]
    if not keys and not required:
        return None
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
    wherever they are nested. A model without an ``answer_embedding``
    (``vqa_baseline``) gets the word table only, with a warning that the
    answer-space half of the transfer does not apply."""
    src_key = _resolve_unique(vlmap_params, "word_emb.embedding",
                              who="stage-1")
    tgt_key = _resolve_unique(vqa_params, "word_emb.embedding",
                              who="stage-2")
    src = vlmap_params[src_key].detach().cpu()
    tgt = vqa_params[tgt_key]
    if tuple(src.shape) != tuple(tgt.shape):
        raise ValueError(f"word table shape mismatch: vlmap "
                         f"{tuple(src.shape)} vs vqa {tuple(tgt.shape)}")
    out = dict(vqa_params)
    out[tgt_key] = src.to(tgt.dtype).clone()
    ans_key = _resolve_unique(vqa_params, "answer_embedding", who="stage-2",
                              required=False)
    if ans_key is None:
        log.warning("transfer_init: model has no 'answer_embedding' table "
                    "(e.g. vqa_baseline): word table transferred, "
                    "answer-space init skipped")
        return out
    tgt_ans = vqa_params[ans_key].detach().cpu().float().numpy()
    if src.shape[1] != tgt_ans.shape[1]:
        raise ValueError(
            f"answer embedding dim mismatch: words give {src.shape[1]}, "
            f"model has {tgt_ans.shape[1]} (set model.answer_dim = word_dim "
            "for transfer)")
    ans = answer_embedding_from_words(src.float().numpy(), word_vocab,
                                      answer_vocab, fallback=tgt_ans)
    out[ans_key] = torch.from_numpy(ans).to(vqa_params[ans_key].dtype)
    log.info("transfer_init: word table %s copied, %d answer rows seeded",
             tuple(src.shape), min(len(answer_vocab), len(ans)))
    return out
