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
import json
import os
import re
from typing import Callable, Dict, List, Optional

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
    step and the dropout generator's state. Saves are synchronous.

    In a multi-process run (``mesh``, a ``parallel.mesh.Mesh`` with a
    process group) every rank calls :meth:`latest_step`, :meth:`save` and
    :meth:`restore`, and the run directory is one that every rank reads
    (a shared file system). Only rank 0 lists it: :meth:`latest_step` is
    its listing, broadcast, and :meth:`save` decides from that listing,
    taken at its first call, and the steps this manager wrote since, so
    no rank can decide otherwise than another and leave it waiting in a
    collective. Rank 0 alone writes, the ranks wait for the file at a
    barrier, and every rank restores from it. A row-sharded table
    (``mesh.shard_params``) is saved whole: ``full(name, tensor)``
    (collective) gives a parameter's or moment's whole table,
    ``local(name, tensor)`` this rank's rows of a restored one; both are
    the identity unless given."""

    _NAME = re.compile(r"ckpt_(\d+)\.pt")
    _ITER = re.compile(r"data_iter_(\d+)\.json")

    def __init__(self, train_dir: str, *, keep: int = 5,
                 save_every: int = 1000, mesh=None,
                 full: Optional[Callable[[str, torch.Tensor],
                                         torch.Tensor]] = None,
                 local: Optional[Callable[[str, torch.Tensor],
                                          torch.Tensor]] = None) -> None:
        self.directory = os.path.abspath(os.path.join(train_dir, "ckpt"))
        os.makedirs(self.directory, exist_ok=True)
        self.keep = max(1, keep)
        self.save_every = max(1, save_every)
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        self.full = full or (lambda name, t: t)
        self.local = local or (lambda name, t: t)
        # Under a mesh: the newest step saved, as save() knows it (None:
        # none; unset until its first call lists the directory).
        self._newest: Optional[int] = None
        self._listed = False

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            self._NAME.fullmatch, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        """The newest step saved in the directory, None without one; under
        a mesh rank 0's listing, broadcast (collective)."""
        if self.mesh is None:
            steps = self.all_steps()
            return steps[-1] if steps else None
        steps = self.all_steps() if self.mesh.is_writer else []
        latest = self.mesh.from_writer(steps[-1] if steps else -1)
        return None if latest < 0 else latest

    def save(self, step: int, state, *, force: bool = False) -> bool:
        """Write ``state`` (a trainer ``TrainState``) as step ``step`` when
        the policy says so; returns whether it wrote."""
        if self.mesh is None:
            latest = self.latest_step()
        else:
            if not self._listed:
                self._newest, self._listed = self.latest_step(), True
            latest = self._newest
        if not force and latest is not None and (
                latest >= step or step % self.save_every):
            return False
        cpu = lambda d: {k: self.full(k, v).detach().cpu()
                         for k, v in d.items()}
        opt = state.opt_state
        payload = {"step": int(step), "params": cpu(state.params),
                   "opt": {"count": int(opt.count), "mu": cpu(opt.mu),
                           "nu": cpu(opt.nu)},
                   "rng": state.rng.get_state()}
        buffers = getattr(state, "buffers", None)
        if buffers:
            payload["buffers"] = cpu(buffers)
        if self.mesh is None or self.mesh.is_writer:
            path = self._path(step)
            tmp = f"{path}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
            for old in self.all_steps()[:-self.keep]:
                os.remove(self._path(old))
        if self.mesh is not None:
            # The file is whole before any rank reads it.
            self.mesh.barrier()
            self._newest = max(step, -1 if latest is None else latest)
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
                p.copy_(self.local(k, ck["params"][k]))
            for k, b in ck.get("buffers", {}).items():
                state.buffers[k].copy_(b)
        opt = state.opt_state
        moved = lambda d, like: {k: self.local(k, v).to(like[k].device)
                                 for k, v in d.items()}
        opt = dataclasses.replace(opt, count=ck["opt"]["count"],
                                  mu=moved(ck["opt"]["mu"], opt.mu),
                                  nu=moved(ck["opt"]["nu"], opt.nu))
        state.rng.set_state(ck["rng"])
        return dataclasses.replace(state, step=ck["step"], opt_state=opt)

    def save_data_iter(self, step: int, state: Dict) -> None:
        """Write an input iterator's JSON state (``GrainTrainIterator.
        get_state()``) as ``data_iter_<step>.json`` beside the step's
        checkpoint, atomically, so a resumed run continues on the exact
        next sample; the states of checkpoints the keep-N policy removed
        go too. Under a mesh rank 0 alone writes."""
        if self.mesh is not None and not self.mesh.is_writer:
            return
        path = os.path.join(self.directory, f"data_iter_{step}.json")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(state, fh)
        os.replace(tmp, path)
        kept = set(self.all_steps()) | {step}
        for name in os.listdir(self.directory):
            m = self._ITER.fullmatch(name)
            if m and int(m.group(1)) not in kept:
                os.remove(os.path.join(self.directory, name))

    def restore_data_iter(self, step: Optional[int] = None) -> Optional[Dict]:
        """The iterator state saved at ``step`` (default: the latest
        checkpoint's), or None where there is none; under a mesh the
        latest step is rank 0's listing (collective)."""
        step = self.latest_step() if step is None else step
        path = os.path.join(self.directory, f"data_iter_{step}.json")
        if step is None or not os.path.exists(path):
            return None
        with open(path) as fh:
            return json.load(fh)


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
