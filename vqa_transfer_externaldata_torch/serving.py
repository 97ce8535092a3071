"""Inference/serving API: load a trained run and answer questions.

    predictor = Predictor("runs/vqa")               # on CUDA
    answers = predictor.answer(features, ["what color is the dog?", ...])

``features`` are [N, cells, C] grids for the attention models, [N, C]
pool5 vectors for ``vqa_baseline`` and [N, S, S, 3] uint8 images for
``vqa_end2end`` (``Predictor.visual_key`` names which; uint8 travels as
uint8).
The eval forward runs the fused GRU and attention kernels on CUDA, at a
fixed batch size (short requests are padded with copies of their first row
and trimmed), and decodes answers through the run's answer vocab.
``device="cpu"`` runs the plain PyTorch versions instead; without it a
machine with no CUDA device raises.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vqa_transfer_externaldata_torch.cli.common import build_spec
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.utils.checkpoint import load_params
from vqa_transfer_externaldata_torch.utils.logging import log

PARAMS_FILE = "params_final.pt"

Visual = Union[np.ndarray, torch.Tensor]


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """``device``, or CUDA when it is None — raising if there is none: the
    card of this process's ``LOCAL_RANK`` (``cuda:<LOCAL_RANK>``) under a
    launcher that sets it (torchrun), else ``cuda``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local)) if local else torch.device("cuda")


class Predictor:
    def __init__(self, train_dir: str, *, batch_size: int = 8,
                 params_path: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.device = resolve_device(device)
        with open(os.path.join(train_dir, "config.json")) as fh:
            saved = json.load(fh)
        flat = {f"{s}.{k}": v for s, sec in saved.items()
                for k, v in sec.items()}
        self.cfg: Config = Config().replace_flat(flat)
        self.batch_size = batch_size
        spec, self.word_vocab, self.answer_vocab = build_spec(self.cfg)
        if spec.stage != "vqa":
            raise ValueError(
                f"{train_dir} holds a stage-1 run ({self.cfg.model.model}); "
                "the Predictor serves stage-2 VQA models")
        self.model = spec.module
        self.visual_key = spec.visual_key  # the store column it reads
        if self.word_vocab is None or self.answer_vocab is None:
            raise ValueError(
                "run config has no vocab paths (and is not synthetic); "
                "serving needs vocab.json / answer_vocab.json")
        if params_path is None:
            params_path = os.path.join(train_dir, PARAMS_FILE)
            if not os.path.exists(params_path):  # a JAX run: explains why
                params_path = os.path.join(train_dir, "params_final")
        self.model.load_state_dict(load_params(params_path))
        self.model.to(self.device).eval()
        # f32 host features are cast to bf16 before they are uploaded when
        # the model computes in bf16 (it casts on arrival anyway: same math,
        # half the bytes). The model's dtype, not the config's: fidelity
        # mode computes in float32 whatever model.dtype says.
        self._vis_cast = (torch.bfloat16
                          if self.model.dtype == torch.bfloat16 else None)
        self._store: Optional[torch.Tensor] = None  # set by stage_store()
        log.info("predictor ready: %s (%s), batch %d on %s", train_dir,
                 self.cfg.model.model, batch_size, self.device)

    def stage_store(self, grid: np.ndarray) -> None:
        """Upload a feature store's visuals once (grids [M, cells, C] or
        [M, g, g, C], or pool5 [M, C] for ``vqa_baseline``; f16/f32);
        :meth:`answer_indexed` then serves requests that name rows of it,
        shipping only the row ids."""
        g = np.asarray(grid)
        if g.ndim == 4:
            g = g.reshape(g.shape[0], -1, g.shape[-1])
        dt = self._vis_cast or torch.float32
        self._store = torch.from_numpy(np.ascontiguousarray(g)).to(
            dt).to(self.device)
        log.info("staged %d-row feature store on %s (%.2f GB)", g.shape[0],
                 self.device,
                 self._store.numel() * self._store.element_size() / 1e9)

    def answer_indexed(self, image_index, questions: Sequence[str]
                       ) -> List[str]:
        """Answer questions about images of the staged store:
        ``image_index`` [N] rows of :meth:`stage_store`'s grid. The range
        is checked here on the host; the gather runs on the device."""
        if self._store is None:
            raise ValueError("no staged store — call stage_store() first")
        idx = np.asarray(image_index)
        if idx.ndim != 1 or not np.issubdtype(idx.dtype, np.integer):
            raise TypeError("image_index must be a 1-D array of integers")
        rows = self._store.shape[0]
        bad = (idx < 0) | (idx >= rows)
        if bad.any():
            raise IndexError(f"image_index {idx[bad][:8].tolist()} out of "
                             f"range for a staged store of {rows} rows")
        sel = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        return self.answer(self._store.index_select(0, sel), questions)

    def _forward(self, v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(v, q)["logits"].argmax(-1)

    def _encode_questions(self, questions: Sequence[str]) -> np.ndarray:
        T = self.cfg.data.max_question_len
        ids = np.zeros((len(questions), T), np.int32)
        for i, q in enumerate(questions):
            ids[i], _ = self.word_vocab.encode(q, T)
        return ids

    def _upload(self, v: Visual) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(v))
        if self._vis_cast is not None and t.dtype in (torch.float32,
                                                      torch.float64):
            t = t.to(self._vis_cast)
        return t.to(self.device)

    def _dispatch_batched(self, visual: Visual, q_ids: np.ndarray
                          ) -> Tuple[List[torch.Tensor], int]:
        """Pad, upload and run each chunk of ``batch_size`` rows; returns
        ``(per-chunk predictions on the device, n)`` without waiting.
        A ``torch.Tensor`` already on the device skips the upload."""
        n = q_ids.shape[0]
        bs = self.batch_size
        handles = []
        for start in range(0, n, bs):
            end = min(start + bs, n)
            pad = bs - (end - start)
            v = self._upload(visual[start:end])
            q = torch.from_numpy(q_ids[start:end]).to(self.device)
            if pad:
                v = torch.cat([v, v[:1].expand(pad, *v.shape[1:])])
                q = torch.cat([q, q[:1].expand(pad, *q.shape[1:])])
            handles.append(self._forward(v, q))
        return handles, n

    def submit(self, visual: Visual, questions: Sequence[str]):
        """Enqueue a request; returns an opaque handle for :meth:`result`.
        ``visual`` as for :meth:`answer`."""
        q_ids = self._encode_questions(questions)
        if len(visual) != q_ids.shape[0]:
            raise ValueError(f"{len(visual)} feature rows for "
                             f"{q_ids.shape[0]} questions")
        return self._dispatch_batched(visual, q_ids)

    def result(self, handle) -> List[str]:
        """Wait for a :meth:`submit` handle and decode answer strings."""
        handles, n = handle
        preds = torch.cat([h.cpu() for h in handles])[:n]
        return [self.answer_vocab.tokens[int(p)] for p in preds]

    def answer(self, visual: Visual, questions: Sequence[str]) -> List[str]:
        """``visual``: [N, grid_cells, C] features (the attention models),
        [N, C] pool5 (``vqa_baseline``) or [N, S, S, 3] uint8 images
        (``vqa_end2end``), host numpy or a ``torch.Tensor``
        (one already on the device skips the upload)."""
        return self.result(self.submit(visual, questions))
