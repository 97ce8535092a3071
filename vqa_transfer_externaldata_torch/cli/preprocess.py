"""Offline dataset preprocessing CLI of the port (numpy only: no card, no
torch), with the JAX package's subcommands, flags and defaults:

    # VQA v2: questions/annotations JSON -> npz tables + vocabs
    python -m vqa_transfer_externaldata_torch.cli.preprocess vqa_v2 \
        --out_dir data/preprocessed/vqa_v2 \
        --train_questions .../v2_OpenEnded_mscoco_train2014_questions.json \
        --train_annotations .../v2_mscoco_train2014_annotations.json \
        [--val_questions ... --val_annotations ...] [--top_k 2000] \
        [--answer_holdout_fraction 0.1] [--feature_path features_dir]

    # Visual Genome: region descriptions -> stage-1 artifacts
    python -m vqa_transfer_externaldata_torch.cli.preprocess visualgenome \
        --out_dir data/preprocessed/vg \
        --region_descriptions .../region_descriptions.json \
        --vocab data/preprocessed/vqa_v2/vocab.json \
        [--num_tasks 32 --num_candidates 512]

    # GloVe: 300-d vectors filtered to the vocab, as an npz matrix
    python -m vqa_transfer_externaldata_torch.cli.preprocess glove \
        --out data/preprocessed/glove_vocab.npz \
        --glove_txt .../glove.6B.300d.txt \
        --vocab data/preprocessed/vqa_v2/vocab.json [--pad_to 8192]

``vqa_v2 --feature_path`` (a feature store: raw directory, npz or hdf5)
sets each question's ``image_index`` to its image's row in that store;
without it every ``image_index`` is 0, as the JAX package's CLI writes.
Task discovery uses WordNet when ``nltk`` and its corpus are installed,
and frequency buckets otherwise.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from vqa_transfer_externaldata_torch.utils.vocab import (
    Vocab, glove_matrix, load_glove_txt, save_matrix)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser("preprocess")
    sub = p.add_subparsers(dest="tool", required=True)

    pv = sub.add_parser("vqa_v2")
    pv.add_argument("--out_dir", required=True)
    pv.add_argument("--train_questions", required=True)
    pv.add_argument("--train_annotations", required=True)
    pv.add_argument("--val_questions")
    pv.add_argument("--val_annotations")
    pv.add_argument("--test_questions")
    pv.add_argument("--top_k", type=int, default=2000)
    pv.add_argument("--max_question_len", type=int, default=26)
    pv.add_argument("--vocab_pad_to", type=int, default=8192)
    pv.add_argument("--answer_holdout_fraction", type=float, default=0.0,
                    help="fraction of answers held out of training "
                         "(the paper's OOV-answer protocol)")
    pv.add_argument("--holdout_seed", type=int, default=0)
    pv.add_argument("--feature_path", default=None,
                    help="feature store whose image_ids give each "
                         "question's image_index (default: all 0)")

    pg = sub.add_parser("visualgenome")
    pg.add_argument("--out_dir", required=True)
    pg.add_argument("--region_descriptions", required=True)
    pg.add_argument("--vocab", required=True)
    pg.add_argument("--num_tasks", type=int, default=32)
    pg.add_argument("--num_candidates", type=int, default=512)
    pg.add_argument("--min_word_count", type=int, default=50)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--descriptions", default=True,
                    type=lambda s: s.lower() in ("1", "true", "yes"),
                    help="also write the description blank-fill artifacts "
                         "(vlmap_desc_*.npz) of vlmap_description")
    pg.add_argument("--max_desc_len", type=int, default=26)

    pw = sub.add_parser("glove")
    pw.add_argument("--out", required=True)
    pw.add_argument("--glove_txt", required=True)
    pw.add_argument("--vocab", required=True)
    pw.add_argument("--dim", type=int, default=300)
    pw.add_argument("--pad_to", type=int, default=8192)

    args = p.parse_args(argv)
    if args.tool == "vqa_v2":
        from vqa_transfer_externaldata_torch.data.vqa_v2 import (
            preprocess_vqa_v2)

        index = None
        if args.feature_path:
            from vqa_transfer_externaldata_torch.data.features import (
                FeatureStore)

            store = FeatureStore(args.feature_path)
            index = store.index_of
            store.close()
        preprocess_vqa_v2(
            args.out_dir, args.train_questions, args.train_annotations,
            val_questions=args.val_questions,
            val_annotations=args.val_annotations,
            test_questions=args.test_questions,
            top_k_answers=args.top_k,
            max_question_len=args.max_question_len,
            vocab_pad_to=args.vocab_pad_to,
            image_id_to_index=index,
            answer_holdout_fraction=args.answer_holdout_fraction,
            holdout_seed=args.holdout_seed)
    elif args.tool == "visualgenome":
        from vqa_transfer_externaldata_torch.data.visualgenome import (
            build_vlmap_artifacts, build_vlmap_description_artifacts,
            load_region_descriptions)

        regions = load_region_descriptions(args.region_descriptions)
        vocab = Vocab.load(args.vocab)
        build_vlmap_artifacts(
            regions, vocab, num_tasks=args.num_tasks,
            num_candidates=args.num_candidates,
            min_word_count=args.min_word_count, seed=args.seed,
            out_dir=args.out_dir)
        if args.descriptions:
            build_vlmap_description_artifacts(
                regions, vocab, num_tasks=args.num_tasks,
                num_candidates=args.num_candidates,
                min_word_count=args.min_word_count,
                max_desc_len=args.max_desc_len, seed=args.seed,
                out_dir=args.out_dir)
    elif args.tool == "glove":
        vocab = Vocab.load(args.vocab)
        vectors = load_glove_txt(args.glove_txt, dim=args.dim, vocab=vocab)
        save_matrix(args.out, glove_matrix(vocab, vectors, dim=args.dim,
                                           pad_to=args.pad_to))


if __name__ == "__main__":
    main(sys.argv[1:])
