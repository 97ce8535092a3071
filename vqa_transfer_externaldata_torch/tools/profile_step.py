"""Profile any registry model's resident training step through the
Trainer's own profiler window, then summarize the trace
(:mod:`.trace_summary`): the counterpart of the JAX repository's
``tools/profile_step.py``.

    python -m vqa_transfer_externaldata_torch.tools.profile_step \\
        --model.model vqa_attention --data.synthetic_layout joined
    python -m vqa_transfer_externaldata_torch.tools.profile_step \\
        --model.model vlmap_description --model.bidirectional_desc true \\
        --steps 16 --top 12
    python -m vqa_transfer_externaldata_torch.tools.profile_step \\
        --device cpu --model.model vlmap --steps 2 --size 64 ...

Takes every ``--section.field`` override (``Config.from_args``) and its
own flags: ``--steps N`` (the profiled window, default 32), ``--top N``
(kernels and host ops listed, default 12), ``--size N`` (synthetic rows,
default 4096 on the card, 256 on the CPU) and ``--device`` (default
cuda). It trains ``3 * steps`` resident steps on the synthetic corpus
(batch 256 on the card, 32 on the CPU, ``train.steps_per_call`` 8 on the
card and 2 on the CPU unless given: the graphed step) and profiles the
middle third, past the upload, the kernel builds and the graph's
capture. Prints one JSON line (trace_summary's, with the model, the
device and the settings) on stdout and the table on stderr. On the CPU the
trace has no device events, so the device figures are null.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import List, Optional

import torch

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data.datasets import load_dataset
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.serving import resolve_device
from vqa_transfer_externaldata_torch.tools import trace_summary

# Fields whose tool default gives way to the user's own value.
USER_FIRST = ("train.batch_size", "train.log_every", "train.max_steps",
              "train.steps_per_call")


def _pop_flag(argv: List[str], name: str, default, kind=int):
    if name in argv:
        i = argv.index(name)
        value = kind(argv[i + 1])
        del argv[i:i + 2]
        return value
    return default


def _get(cfg: Config, flat: str):
    section, field = flat.split(".")
    return getattr(getattr(cfg, section), field)


def main(argv: Optional[List[str]] = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    steps = _pop_flag(argv, "--steps", 32)
    top = _pop_flag(argv, "--top", 12)
    size = _pop_flag(argv, "--size", 0)
    device = resolve_device(_pop_flag(argv, "--device", None, str))
    card = device.type == "cuda"
    user = Config.from_args(argv)
    base = Config()
    tool = {
        "data.synthetic": True,
        "data.synthetic_size": size or (4096 if card else 256),
        "train.batch_size": 256 if card else 32,
        "train.log_every": steps, "train.max_steps": 3 * steps,
        "train.steps_per_call": min(8, steps) if card else 2,
        "train.checkpoint_every": 10 ** 9, "train.eval_every": 10 ** 9,
        "train.device_data_cache": True,
        "train.profile_start": 2 * steps, "train.profile_steps": steps,
    }
    for flat in USER_FIRST:
        if _get(user, flat) != _get(base, flat):
            tool.pop(flat)
    cfg = user.replace_flat(tool)
    spec = build_model(cfg, generator=torch.Generator().manual_seed(
        cfg.train.seed))
    ds = load_dataset(cfg, "train", stage=spec.stage)
    train_dir = tempfile.mkdtemp(prefix="profile_step_")
    trainer = Trainer(cfg, spec, train_dir=train_dir, device=str(device))
    trainer.fit_resident(ds, trainer.init_state())
    trainer.close()
    res = trace_summary.summarize(os.path.join(train_dir, "profile"),
                                  top=top)
    trace_summary.report(res)
    out = dict(res, model=cfg.model.model, device=str(device),
               device_name=(torch.cuda.get_device_name(device) if card
                            else "cpu"),
               batch_size=cfg.train.batch_size,
               steps_per_call=cfg.train.steps_per_call,
               rows=ds.size)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
