"""Training CLI of the port, for both stages (dispatched by
``--model.model``), on the synthetic corpora or on the preprocessed
artifacts of ``cli.preprocess`` (``--data.dataset_dir``, joined with a
feature store by ``--data.feature_path``; the vocabs from
``--data.vocab_path`` and ``--data.answer_vocab_path``, GloVe rows from
``--data.glove_path``):

    # stage 1 (visual-word pretraining), device-resident
    python -m vqa_transfer_externaldata_torch.cli.train \
        --model.model vlmap_description --model.bidirectional_desc true \
        --data.synthetic true --train.device_data_cache true \
        --train.train_dir runs/vlmap
    # stage 2 (VQA), transfer-initialized from stage 1's parameters
    python -m vqa_transfer_externaldata_torch.cli.train \
        --data.synthetic true --data.synthetic_layout joined \
        --train.device_data_cache true --train.train_dir runs/vqa \
        --train.pretrained_param_path runs/vlmap/params_final.pt
    # stage 2 on streamed host batches (the config's default)
    python -m vqa_transfer_externaldata_torch.cli.train \
        --data.synthetic true --train.train_dir runs/vqa_streamed

``--train.device_data_cache true`` trains with ``Trainer.fit_resident``
(the split uploaded once), otherwise ``Trainer.fit`` streams host batches,
as it does for a stage-1 split with resampled negatives (with a warning
when the cache was asked for). The val split, where there is one, is
evaluated every ``train.eval_every`` steps. Writes
``config.json``, ``metrics.jsonl``, checkpoints under ``ckpt/`` and
``params_final.pt`` (served by ``serving.Predictor`` for a stage-2 run)
into the run directory and returns its path; a run directory that holds a
checkpoint is resumed from its latest one unless ``--train.resume false``.
``vqa_end2end`` trains on raw images (``--data.image_dir`` with the
artifacts, or synthetic pixels), its backbone converted from
``--model.resnet_checkpoint`` (a torchvision resnet101 state dict) when
given. Runs on CUDA unless ``--device cpu``.

``--data.input_pipeline grain`` streams every dataset through
``data/grain_loader.GrainTrainIterator`` (``--data.grain_workers`` worker
processes; ``train.device_data_cache`` is ignored, with a warning): its
state is saved beside each checkpoint as ``ckpt/data_iter_<step>.json``,
and a resumed run restores it, so it continues on the exact next sample.

Multi-device (one process per card; ``--mesh.num_model`` and
``--mesh.shard_params`` for tensor-parallel tables):

    python -m torch.distributed.run --nproc_per_node 4 \
        -m vqa_transfer_externaldata_torch.cli.train ... \
        [--mesh.num_model 2 --mesh.shard_params answer_embedding,word_emb]

The process group starts before the first device query
(``parallel.mesh.initialize_distributed_from``: NCCL on the cards, gloo
with ``--device cpu``); each rank runs on ``cuda:<LOCAL_RANK>``, streamed
training reads its shard of every global batch, and rank 0 writes
``config.json``, ``metrics.jsonl``, the checkpoints and
``params_final.pt`` (the tables whole).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import torch

from vqa_transfer_externaldata_torch.cli.common import (
    build_spec, load_resnet_backbone, rank_device, resolve_train_dir)
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data.datasets import (
    ArrayDataset, load_dataset)
from vqa_transfer_externaldata_torch.data.features import JoinedDataset
from vqa_transfer_externaldata_torch.parallel.evaler import padded_batches
from vqa_transfer_externaldata_torch.parallel.mesh import (
    create_mesh, initialize_distributed_from)
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.serving import PARAMS_FILE
from vqa_transfer_externaldata_torch.utils.checkpoint import (
    load_params, save_params, transfer_init)
from vqa_transfer_externaldata_torch.utils.logging import log


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args, rest = p.parse_known_args(argv)
    cfg = Config.from_args(rest)
    t = cfg.train
    started = initialize_distributed_from(
        cfg, backend="gloo" if args.device == "cpu" else None)
    mesh = create_mesh(cfg, rank_device(args.device))
    spec, word_vocab, answer_vocab = build_spec(
        cfg, generator=torch.Generator().manual_seed(t.seed))
    if t.pretrained_param_path and spec.stage != "vqa":
        raise ValueError("--train.pretrained_param_path only applies to "
                         "stage-2 (vqa) models")
    train_dir = resolve_train_dir(cfg, spec.stage)
    trainer = Trainer(cfg, spec, mesh=mesh, train_dir=train_dir)
    log.info("train_dir: %s  device: %s  %s", train_dir, trainer.device,
             mesh)
    os.makedirs(train_dir, exist_ok=True)
    if mesh.is_writer:
        with open(os.path.join(train_dir, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
    train_ds = load_dataset(cfg, "train", stage=spec.stage)
    try:
        val_ds = load_dataset(cfg, "val", stage=spec.stage)
    except FileNotFoundError:  # artifacts without a val split
        val_ds = None
    # The raw-image model's pretrained backbone (weights and BatchNorm
    # statistics) replaces its random one before any transfer or resume.
    backbone = load_resnet_backbone(cfg)
    if backbone is not None:
        spec.module.resnet.load_state_dict(backbone)
    params = None
    if t.pretrained_param_path:
        # Cross-stage transfer: stage 1's word table, and answer rows
        # seeded from it where the model has an answer table, into the
        # freshly initialized stage-2 model.
        if word_vocab is None or answer_vocab is None:
            raise ValueError("transfer init needs the word and answer vocabs")
        params = transfer_init(spec.module.state_dict(),
                               load_params(t.pretrained_param_path),
                               word_vocab, answer_vocab)
        log.info("transfer init applied from %s", t.pretrained_param_path)
    state = trainer.init_state(params)
    # Resume after the transfer: a resumed run keeps its trained values.
    resumed = t.resume and trainer.ckpt.latest_step() is not None
    if resumed:
        state = trainer.restore(state)
        log.info("resumed from step %d", state.step)
    eval_fn = None if val_ds is None else \
        lambda: padded_batches(val_ds, t.batch_size)[0]
    # A CandidateResampler's fresh negatives exist only as host batches.
    resident = isinstance(train_ds, JoinedDataset) or \
        type(train_ds) is ArrayDataset
    if cfg.data.input_pipeline == "grain":
        from vqa_transfer_externaldata_torch.data.grain_loader import (
            GrainTrainIterator)

        if t.device_data_cache:
            log.warning("input_pipeline=grain streams batches; "
                        "device_data_cache is ignored")
        train_iter = GrainTrainIterator(
            train_ds, batch_size=t.batch_size, seed=t.seed,
            workers=cfg.data.grain_workers,
            shard=(mesh.data_index, mesh.num_data),
            read_ahead=t.prefetch_batches)
        it_state = trainer.ckpt.restore_data_iter() if resumed else None
        if it_state is not None:
            train_iter.set_state(it_state)
            log.info("grain iterator state restored: %s", it_state)
        state = trainer.fit(train_iter, state, eval_batches_fn=eval_fn)
    elif t.device_data_cache and resident:
        state = trainer.fit_resident(train_ds, state, eval_ds=val_ds)
    else:
        if t.device_data_cache:
            log.warning("device_data_cache requires an ArrayDataset or "
                        "JoinedDataset (got %s); streaming batches instead",
                        type(train_ds).__name__)
        # Each data rank streams its shard of every global batch.
        shard = ((mesh.data_index, mesh.num_data) if mesh.num_data > 1
                 else None)
        state = trainer.fit(
            train_ds.batches(t.batch_size, seed=t.seed, shard=shard), state,
            eval_batches_fn=eval_fn)
    final = os.path.join(train_dir, PARAMS_FILE)
    params = trainer.full_state_dict()
    if mesh.is_writer:
        save_params(final, params)
        log.info("final params saved to %s", final)
    trainer.close()
    if mesh.is_writer:
        print(json.dumps({"train_dir": train_dir, "steps": state.step}))
    if started:
        torch.distributed.destroy_process_group()
    return train_dir


if __name__ == "__main__":
    main(sys.argv[1:])
